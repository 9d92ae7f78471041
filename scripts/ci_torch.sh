#!/usr/bin/env bash
# CI lane of the PyTorch + CUDA port (pothoscomms_tpu_torch), beside
# scripts/ci.sh: the port's tests on the CPU (held against the JAX
# package), a gloo dry run of two ranks, the benchmark's CPU tests and
# the port's wheel smoke.
# Run from anywhere in the checkout; prints one line per stage, uses no
# network, and exits non-zero on any failure:
#
#   bash scripts/ci_torch.sh
set -euo pipefail
cd "$(dirname "$0")/.."
WORK="$(mktemp -d)"
trap 'rm -rf "$WORK"' EXIT

echo "== stage 1: the port's tests (tests/test_torch_*.py, CPU) =="
JAX_PLATFORMS=cpu python -m pytest tests/test_torch_*.py -q --tb=short \
  -p xdist -n 4 --dist loadfile

echo "== stage 2: dry run of two gloo ranks, one process each =="
for r in 0 1; do
  python -m pothoscomms_tpu_torch.parallel.dryrun --world 2 --rank "$r" \
    --store "$WORK/store" --scenario dryrun --out "$WORK" --device cpu \
    > "$WORK/rank$r.log" 2>&1 &
  PIDS[$r]=$!
done
FAILED=0
for r in 0 1; do
  if ! wait "${PIDS[$r]}"; then
    echo "rank $r failed:"; cat "$WORK/rank$r.log"; FAILED=1
  elif ! grep -q "RANK $r OK" "$WORK/rank$r.log"; then
    echo "rank $r did not report:"; cat "$WORK/rank$r.log"; FAILED=1
  fi
done
test "$FAILED" -eq 0
python - "$WORK" <<'PY'
import pickle
import sys
from pathlib import Path

for r in (0, 1):
    out = pickle.loads((Path(sys.argv[1]) / f"rank{r}.pkl").read_bytes())
    assert set(out) == {"channel_fir_fft", "time_fir", "fm_chain",
                        "grid_fir"}, out
    print(f"rank {r}: {out}")
PY
echo "dryrun ok"

echo "== stage 3: the benchmark's tests (benchmark/tests, CPU) =="
python -m pytest benchmark/tests -q --tb=short -p no:cacheprovider

echo "== stage 4: wheel build + clean-venv install + CLI smoke =="
bash scripts/wheel_smoke_torch.sh

echo "CI GREEN (torch)"
