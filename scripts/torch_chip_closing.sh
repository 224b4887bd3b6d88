#!/usr/bin/env bash
# The port's closing checks on one NVIDIA card. Run from the repo root:
#
#     bash scripts/torch_chip_closing.sh [PARENT_DIR]
#
# 1. the card's name and power limit (nvidia-smi);
# 2. chip_smoke.py: once, or with PARENT_DIR (an older checkout unpacked
#    inside this one, e.g. `git archive HEAD~1 | tar -x -C build/parent`)
#    the parent's and this tree's in turns: parent, change, change, parent;
# 3. the card tests, tests/test_torch_cuda.py, tests/test_torch_p2l_gn.py and
#    tests/test_torch_epilogue.py
#    (marker cuda);
# 4. python -m rmcl_tpu_torch.bench with the factored engine, the dense
#    engine (BENCH_ENGINE=dense) and the fused reduction (BENCH_FUSED=1);
# 5. scripts/torch_cp_split_probe.py, scripts/torch_k5_probe.py,
#    scripts/torch_k7_probe.py and scripts/torch_k3_probe.py (each with
#    --parent PARENT_DIR if given), and
#    scripts/torch_trace_probe.py
#    (K2g and K1 at phase 13's inputs by the device trace, in a process of
#    their own).
#
# Each step's output goes to $CLOSING_OUT/closing_<step>.log (by default
# the git-ignored build/closing/) and its exit code is printed; the script
# exits nonzero if any step failed.
set -u
out=${CLOSING_OUT:-build/closing}
mkdir -p "$out"
parent=${1:-}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
status=0

step() {  # step NAME DIR COMMAND...: run COMMAND in DIR, log it, note its rc
  local name=$1 dir=$2
  shift 2
  (cd "$dir" && "$@") >"$out/closing_$name.log" 2>&1
  local rc=$?
  echo "$name rc $rc"
  [ "$rc" -eq 0 ] || status=1
}

if [ -n "$parent" ]; then
  step smoke_parent1 "$parent" python3 chip_smoke.py
  step smoke_change1 . python3 chip_smoke.py
  step smoke_change2 . python3 chip_smoke.py
  step smoke_parent2 "$parent" python3 chip_smoke.py
else
  step smoke . python3 chip_smoke.py
fi
step cardtests . python3 -m pytest tests/test_torch_cuda.py tests/test_torch_p2l_gn.py \
  tests/test_torch_epilogue.py --noconftest \
  -o addopts= -m cuda -q \
  -p no:cacheprovider
tail -n 3 "$out/closing_cardtests.log"
# the corrector benchmark's three variants: factored, dense (K2g), fused
for pair in factored:BENCH_ENGINE=factored dense:BENCH_ENGINE=dense fused:BENCH_FUSED=1; do
  name=bench_${pair%%:*}
  step "$name" . env "${pair#*:}" python3 -m rmcl_tpu_torch.bench
  tail -n 1 "$out/closing_$name.log"
done
for probe in cp_split k5 k7 k3; do
  if [ -n "$parent" ]; then
    step "probe_$probe" . python3 -m "scripts.torch_${probe}_probe" --parent "$parent"
  else
    step "probe_$probe" . python3 -m "scripts.torch_${probe}_probe"
  fi
  cat "$out/closing_probe_$probe.log"
done
step probe_trace . python3 -m scripts.torch_trace_probe
grep '"step"' "$out/closing_probe_trace.log"
exit $status
