#!/bin/bash
# The port's on-card measurement queue: the rows of
# scripts/torch/kernel_bench.py, the five configurations of
# scripts/torch/collect_baseline.py and the headline
# (python -m starway_tpu_torch.headline), run one after another on an
# NVIDIA GPU.  The twin of scripts/onchip_refresh.sh.
#
# RESUMABLE: a section is skipped when $OUT already holds its success row
# (an "error" row does not count), so a rerun after a lost machine goes
# straight to the rows still pending.  Fast, high-value rows come first
# (headline, the nine kernels' numerics, the train step, serving); the
# sweeps come last.  A row killed by its timeout keeps every row it
# printed before, and adds an error row naming the exit code.
#
# Usage:  bash scripts/torch/onchip_refresh.sh [outfile]
#           (default build/onchip/onchip_rows.json in the checkout)
#         FORCE=1 re-measures everything regardless of existing rows.
#         ROWS="check serve" runs only the named sections.
#         REHEARSAL=1 runs every row's exact command on the CPU at the
#         scaled sizes of kernel_bench.REHEARSAL_KW (the pre-flight that no
#         row has a shape bug); default outfile
#         build/onchip/rehearsal_rows.json.
set -u
cd "$(dirname "$0")/../.."
REHEARSAL="${REHEARSAL:-0}"
mkdir -p build/onchip
if [ "$REHEARSAL" = "1" ]; then
  export STARWAY_BENCH_REHEARSAL=1 STARWAY_BENCH_CPU=1
  OUT="${1:-build/onchip/rehearsal_rows.json}"
  HEADLINE_FLAGS="--device cpu"
else
  OUT="${1:-build/onchip/onchip_rows.json}"
  HEADLINE_FLAGS=""
fi
touch "$OUT"

probe() {
  if [ "$REHEARSAL" = "1" ]; then
    timeout 90 python -c "import torch; float((torch.ones(4) + 1).sum())" \
      2>/dev/null || { echo "CPU torch unusable; aborting" >&2; exit 1; }
    return
  fi
  timeout 90 python -c "import torch; assert torch.cuda.is_available(); float((torch.ones(4, device='cuda') + 1).sum())" \
    2>/dev/null || { echo "CUDA device unresponsive; aborting" >&2; exit 1; }
}

have() {  # have <metric>: a non-error row for <metric> is already recorded
  [ "${FORCE:-0}" = "1" ] && return 1
  grep "\"metric\": \"$1\"" "$OUT" | grep -qv '"error"'
}

want() {  # ROWS="a b c" restricts the queue to named rows; unset = all
  [ -z "${ROWS:-}" ] && return 0
  case " $ROWS " in *" $1 "*) return 0 ;; *) return 1 ;; esac
}

run_cmd() {  # [ROW_TIMEOUT=secs] run_cmd <name> <done_metric> <command...>
  local name="$1" done_key="$2"; shift 2
  want "$name" || return 0
  if have "$done_key"; then echo "== $name (already measured; skip)" >&2; return; fi
  echo "== $name" >&2
  probe  # the machine can go mid-queue; fail fast, not per-row timeouts
  local log tmp rc t="${ROW_TIMEOUT:-1200}"
  log="$(mktemp)"; tmp="$(mktemp)"
  timeout "$t" "$@" >"$tmp" 2>"$log"
  rc=$?
  grep '"metric"' "$tmp" | tee -a "$OUT"
  # kernel_bench catches a row's exception into an {"error": ...} row and
  # goes on: an error row in the output is a failure too (keep the log).
  if [ $rc -ne 0 ] || ! grep -q '"metric"' "$tmp" || grep -q '"error"' "$tmp"; then
    echo "{\"metric\": \"${name}\", \"error\": \"rc=$rc (124=timeout); see $log\"}" \
      | tee -a "$OUT" >&2
  else
    rm -f "$log"
  fi
  rm -f "$tmp"
}

run() {  # [ROW_TIMEOUT=secs] run <which> <done_metric> [extra flags...]
  local which="$1" done_key="$2"; shift 2
  run_cmd "$which" "$done_key" python scripts/torch/kernel_bench.py \
    --which "$which" "$@"
}

probe
if [ "${FORCE:-0}" = "1" ]; then
  # A re-measure must not leave two conflicting rows per metric, but the
  # old rows go only once the device has answered a probe.
  : > "$OUT"
fi

# -- fast, high-value rows first ---------------------------------------------
if ! want headline; then
  : # ROWS filter excludes the headline
elif have headline_recorded; then
  echo "== headline (already measured; skip)" >&2
else
  echo "== headline (python -m starway_tpu_torch.headline)" >&2
  tmp="$(mktemp)"
  timeout 600 python -m starway_tpu_torch.headline $HEADLINE_FLAGS >"$tmp" 2>/dev/null
  # In a rehearsal the headline runs on CPU tensors and says so
  # ("fallback": true): the expected outcome there, a failure on the card.
  if [ "$REHEARSAL" = "1" ]; then bad='"error"'; else bad='"fallback": true\|"error"'; fi
  if grep -q vs_baseline "$tmp" && ! grep -q "$bad" "$tmp"; then
    tee -a "$OUT" < "$tmp"
    # A marker row, so a rerun sees that the headline landed.
    echo '{"metric": "headline_recorded", "value": 1, "unit": "done"}' >> "$OUT"
  else
    cat "$tmp"; echo '{"metric": "headline_recorded", "error": "fallback or no output"}' | tee -a "$OUT" >&2
  fi
  rm -f "$tmp"
fi

run check            check_flash_fwd_onchip             # the nine kernels against their plain versions
run train_mfu        train_step_mfu
run serve            serve_llama_b1_tokens_per_s        # end-to-end generate() tok/s
run serve_b8         serve_llama_b8_tokens_per_s
run serve_mistral    serve_mistral_b1_tokens_per_s      # rolling O(window) cache path
run serve_mixtral    serve_mixtral_b1_tokens_per_s      # dropless top-2 MoE decode
run serve_ragged_b8  serve_llama_ragged_b8_tokens_per_s # mixed prompt lengths
run serve_continuous serve_continuous_tokens_per_s      # wall clock through slot reuse
run decode_int8      decode_int8_us_per_token           # int8 cache stream
run decode_paged     decode_paged_us_per_token          # page table vs dense (compare decode_ours)
run serve_int8_b8    serve_llama_int8_b8_tokens_per_s   # int8 cache end to end
run spec_verify      spec_verify_amortisation           # chunk verify vs gamma decode steps
run serve_prefix     serve_prefix_admit_speedup         # prefix-cached admission vs full prefill
run gemv_int8        gemv_int8_speedup                  # W8A16 weight stream vs bf16
run serve_w8_b1      serve_llama_int8_w8_b1_tokens_per_s # int8 KV and weights
run_cmd baseline     baseline_configs python scripts/torch/collect_baseline.py --json
# The 672M-parameter train step at S=8192 takes longer than the default
# row timeout; give it headroom.
ROW_TIMEOUT="${ROW_TIMEOUT_LARGE:-3000}" run train_mfu_large train_step_mfu_large
run decode_shapes    decode_shape_wins                  # ours vs SDPA at three more shapes

# -- re-confirmation rows -----------------------------------------------------
run matmul           matmul_ceiling_tflops
run flash            flash_fwd_ours_tflops
run flash_stock      flash_fwd_stock_tflops
run flash_window     flash_window_tflops
run flash_bwd        flash_fwdbwd_ours_tflops
run flash_bwd_stock  flash_fwdbwd_stock_tflops
run decode           decode_ours_us_per_token
run decode_lax       decode_lax_us_per_token

# -- the sweep last -------------------------------------------------------------
ROW_TIMEOUT="${ROW_TIMEOUT_LARGE:-2400}" run decode_tune decode_best_config

echo "rows written to $OUT" >&2
