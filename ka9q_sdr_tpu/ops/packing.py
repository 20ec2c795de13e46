"""Real<->complex packing for jit boundaries.

The convention throughout this framework: **every jit boundary is
real-dtype only**.  Complex arithmetic lives inside jit; state and I/O
cross the boundary as float32 real/imag pairs packed on a trailing axis.
CUDA transfers complex64 directly, so the convention is no longer
required; removing it is a design item of its own (ROADMAP.md).

These helpers are shape-stable and fuse away inside jit (they lower to a
stack/slice, which XLA folds into the surrounding computation).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["c2r", "r2c", "tree_c2r", "tree_r2c", "c2r_np", "tree_c2r_np"]


def c2r(x: jax.Array) -> jax.Array:
    """complex (...,) -> float32 (..., 2)."""
    return jnp.stack([jnp.real(x), jnp.imag(x)], axis=-1)


def r2c(x: jax.Array) -> jax.Array:
    """float32 (..., 2) -> complex64 (...,)."""
    return jax.lax.complex(x[..., 0], x[..., 1])


def tree_c2r(tree):
    """Map c2r over every complex leaf of a pytree (real leaves pass
    through).  Use on jit outputs that carry complex state."""
    return jax.tree_util.tree_map(
        lambda v: c2r(v) if jnp.iscomplexobj(v) else v, tree
    )


def tree_r2c(tree, template):
    """Inverse of tree_c2r given a template pytree marking which leaves were
    complex (by dtype)."""
    return jax.tree_util.tree_map(
        lambda v, t: r2c(v) if jnp.iscomplexobj(t) else v, tree, template
    )


def c2r_np(x):
    """Host-side (numpy) c2r, for building initial packed state without
    touching the device."""
    import numpy as np

    x = np.asarray(x)
    return np.stack([x.real, x.imag], axis=-1).astype(np.float32)


def tree_c2r_np(tree):
    import numpy as np

    return jax.tree_util.tree_map(
        lambda v: c2r_np(v) if np.iscomplexobj(np.asarray(v)) else np.asarray(v),
        tree,
    )
