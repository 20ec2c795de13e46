#!/bin/bash
# Full-constellation soak: frontend (sim) -> radio -> {opusd, packetd} ->
# monitor, with control watching.  The reference verifies by field
# operation (SURVEY.md §4); this is the lab equivalent.
# Usage: tools/soak.sh [seconds]
set -u
SECS=${1:-60}
B=239.99.20
export PYTHONPATH=${PYTHONPATH:-$(cd "$(dirname "$0")/.." && pwd)}
PY=python
trap 'kill $(jobs -p) 2>/dev/null' EXIT

$PY -m ka9q_sdr_tpu.apps.frontend -R $B.1:5004 -f 146m52 -r 192000 \
    --iq-file "${SOAK_IQ:-/tmp/test_am.iq}" --seconds $((SECS+30)) 2>/tmp/soak_fe.err &
sleep 1
$PY -m ka9q_sdr_tpu.apps.radio -I $B.1:5004 -R $B.2:5004 -f 146m568 -m AM \
    ${SOAK_RADIO_FLAGS:---cpu} 2>/tmp/soak_radio.err &
RADIO=$!
$PY -m ka9q_sdr_tpu.apps.opusd -I $B.2:5004 -R $B.3:5004 -o 32000 2>/tmp/soak_opus.err &
$PY -m ka9q_sdr_tpu.apps.packetd -I $B.2:5004 -R $B.4:5004 2>/tmp/soak_pkt.err &
$PY -m ka9q_sdr_tpu.apps.monitor $B.3:5004 --seconds $SECS > /tmp/soak_mix.s16 2>/tmp/soak_mon.err &
MON=$!
sleep $((SECS - 10))
$PY -m ka9q_sdr_tpu.apps.control $B.2:5004 --once > /tmp/soak_control.txt 2>/dev/null
wait $MON
kill $RADIO 2>/dev/null
exit 0
