#!/usr/bin/env bash
# The 512 px quality gate several times side by side on one card, through
# scripts/qg512_probe.py (every step logged). A run is named <arith>_seed<N>
# (init seed N), the arithmetic one of:
#   bf16        the port's bf16 training
#   f32         f32 with TF32 off
#   bf16chain   the probe's --f32_chain 1
#   mxu         the probe's --mxu 1 (the TPU MXU's arithmetic)
# A run that spiked and stayed above loss 10 for 1000 steps is cut.
# Logs and outputs go to chiprun_out/g1/; each run's last lines (its
# probe summary and the gate's result) are printed at the end. The exit
# code is 0 when every run reached its summary, whether the gate passed
# or not.
#
#   bash scripts/g1_seeds.sh STEPS TIME_LIMIT_S RUN [RUN ...]
#   e.g. bash scripts/g1_seeds.sh 8000 3300 bf16_seed1 bf16_seed2 f32_seed0
set -u
steps=$1
limit=$2
shift 2
out=chiprun_out/g1
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for name in "$@"; do
  seed=${name##*_seed}
  case $name in
    bf16_seed*) extra=() ;;
    bf16chain_seed*) extra=(--f32_chain 1) ;;
    mxu_seed*) extra=(--mxu 1) ;;
    f32_seed*) extra=(--tf32 0 --compute_dtype float32) ;;
    *) echo "unknown run $name"; exit 2 ;;
  esac
  (timeout "$limit" python3 scripts/qg512_probe.py --steps "$steps" \
     --every 500 --seed "$seed" --log "$out/$name.jsonl" \
     --out "build/qg_$name" ${extra[@]+"${extra[@]}"} > "$out/$name.out" 2>&1
   echo "$name rc=$?" >> "$out/$name.out") &
done
wait
status=0
for name in "$@"; do
  echo "== $name"
  grep -E "^(probe summary|\{\"steps\"|GATE|bf16:|int8:|final loss|.*mxu_conv)" \
    "$out/$name.out" | cut -c1-1500
  tail -n 1 "$out/$name.out"
  grep -q "probe summary" "$out/$name.out" || status=1
done
exit $status
