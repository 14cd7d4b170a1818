#!/bin/bash
# The port's twin of scripts/tpu_watchdog.sh: probe the NVIDIA GPU every
# ~90 s (nvidia-smi, then a one-line CUDA op); the moment it answers, run
# the resumable measurement queue (scripts/torch/onchip_refresh.sh).  It
# repeats: after a queue run (complete, or aborted when the card stopped
# answering) it goes back to probing, so a later window picks up the rows
# still pending.
#
# Markers, under $WATCH_DIR (default build/gpu_watchdog in the checkout),
# for anything polling progress:
#   gpu_alive             touched each time a probe succeeds
#   gpu_refresh_running   exists while onchip_refresh.sh runs
#   onchip_rows.json      the accumulated measured rows
# Log: $WATCH_DIR/gpu_watchdog.log
#
# Usage:  bash scripts/torch/gpu_watchdog.sh      (ONCE=1: one pass, no loop)
set -u
cd "$(dirname "$0")/../.."
WATCH_DIR="${WATCH_DIR:-build/gpu_watchdog}"
mkdir -p "$WATCH_DIR"
LOG="$WATCH_DIR/gpu_watchdog.log"
# The running marker must not outlive the process (a stale marker reads as
# "refresh in flight" forever to anything polling it).
trap 'rm -f "$WATCH_DIR/gpu_refresh_running"' EXIT

probe() {
  timeout 60 nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
      >/dev/null 2>&1 \
    && timeout 60 python -c "import torch; assert torch.cuda.is_available(); float((torch.ones(4, device='cuda') + 1).sum())" \
      >/dev/null 2>&1
}

while true; do
  if probe; then
    date "+%F %T card ALIVE: starting the refresh queue" >> "$LOG"
    touch "$WATCH_DIR/gpu_alive" "$WATCH_DIR/gpu_refresh_running"
    bash scripts/torch/onchip_refresh.sh "$WATCH_DIR/onchip_rows.json" \
      >> "$LOG" 2>&1
    rm -f "$WATCH_DIR/gpu_refresh_running"
    date "+%F %T refresh queue exited" >> "$LOG"
    [ "${ONCE:-0}" = "1" ] && exit 0
    # The queue skips measured rows in seconds once complete, so looping
    # on costs little.
    sleep 300
  else
    date "+%F %T card not answering" >> "$LOG"
    [ "${ONCE:-0}" = "1" ] && exit 1
    sleep 90
  fi
done
