"""DSP primitives: JAX equivalents of the reference's libradio math.

Reference files covered: filter.c/filter.h (fast-convolution engine and
Kaiser design), osc.c/osc.h (complex NCO), dsp.c/dsp.h (helpers),
decimate.c (half-band cascade).
"""

from .window import (
    i0,
    make_kaiser,
    window_filter,
    window_rfilter,
    brickwall_response,
    design_bandpass,
)
from .fftfilt import (
    FilterType,
    MasterSpec,
    SlaveSpec,
    master_init,
    master_execute,
    slave_execute,
    noise_gain,
    set_filter_response,
)
from .nco import (
    OscState,
    osc_init,
    set_osc,
    set_osc_traced,
    osc_block,
    split_double,
    phase_ramp,
    nco_mix,
    osc_advance,
)
from .iir import one_pole_lowpass, dc_block, notch_init, notch_block
from .agc import AGCParams, agc_init, agc_block
from .ffill import forward_fill
from .decimate import hb15_coeffs, hb15_block, hb3_block, hb_cascade
from .packing import c2r, r2c, tree_c2r, tree_r2c
