#!/usr/bin/env bash
# Wheel build + clean-venv install smoke test of the PyTorch + CUDA port
# (pothoscomms_tpu_torch), the counterpart of scripts/wheel_smoke.sh.
#
# Builds the wheel from pyproject.toml, installs it into a FRESH venv
# (dependencies such as torch and numpy come from the invoking environment
# through a .pth link: the wheel itself installs with --no-deps --no-index,
# so nothing is fetched), and from a neutral working directory, so that
# only the installed wheel provides the package:
#   - runs feeder -> /comms/scale -> collector on Topology(device="cpu");
#   - streams bits through a multiplicative /comms/scrambler and
#     descrambler, which builds the C++ LFSR from the wheel's native/src/;
#   - checks that importing the port imported no jax;
#   - checks that the pothoscomms-tpu-torch console script lists all 116
#     block paths, and that its bench command exits 2 with the "source
#     checkout" message (benches_torch/ is not packaged).
#
# Usage: bash scripts/wheel_smoke_torch.sh
set -euo pipefail
REPO="$(cd "$(dirname "$0")/.." && pwd)"
WORK="$(mktemp -d)"
trap 'rm -rf "$WORK"' EXIT

echo "== building wheel =="
cd "$REPO"
python -m pip wheel . --no-deps --no-build-isolation -w "$WORK/dist" -q
WHEEL="$(ls "$WORK"/dist/pothoscomms_tpu-*.whl)"
echo "built: $WHEEL"

echo "== creating fresh venv =="
python -m venv "$WORK/venv"
BASESITE=$(python -c "import sysconfig; print(sysconfig.get_paths()['purelib'])")
VENVSITE=$("$WORK/venv/bin/python" -c \
  "import sysconfig; print(sysconfig.get_paths()['purelib'])")
echo "$BASESITE" > "$VENVSITE/base-deps.pth"
"$WORK/venv/bin/pip" install --no-deps --no-index -q "$WHEEL"

echo "== smoke: topology, native LFSR and no jax, from the installed wheel =="
cd "$WORK"
HOME="$WORK/home" XDG_CACHE_HOME= "$WORK/venv/bin/python" - "$REPO" <<'EOF'
import sys
from pathlib import Path

repo = Path(sys.argv[1])
import numpy as np

import pothoscomms_tpu_torch
from pothoscomms_tpu_torch import BlockRegistry, Topology, native
from pothoscomms_tpu_torch.core.fixtures import CollectorSink, FeederSource
from pothoscomms_tpu_torch.kernels import build

pkg = Path(pothoscomms_tpu_torch.__file__).resolve()
assert "venv" in pkg.parts and repo not in pkg.parents, pkg

feed = FeederSource("float32")
feed.feed_buffer(np.arange(1000, dtype=np.float32))
blk = BlockRegistry.make("/comms/scale", "float32")
blk.set_factor(2.5)
sink = CollectorSink("float32")
topo = Topology(device="cpu")
topo.connect(feed, 0, blk, 0)
topo.connect(blk, 0, sink, 0)
assert topo.wait_inactive()
out = sink.get_buffer()
np.testing.assert_allclose(out, np.arange(1000) * 2.5, rtol=1e-6)
print("topology smoke OK:", len(out), "elements")

bits = np.random.default_rng(5).integers(0, 2, 4096).astype(np.uint8)
feed = FeederSource("uint8")
feed.feed_buffer(bits)
scr = BlockRegistry.make("/comms/scrambler")
dsc = BlockRegistry.make("/comms/descrambler")
for b in (scr, dsc):
    b.set_mode("multiplicative")
mid, sink = CollectorSink("uint8"), CollectorSink("uint8")
topo = Topology(device="cpu")
topo.connect(feed, 0, scr, 0)
topo.connect(scr, 0, dsc, 0)
topo.connect(scr, 0, mid, 0)
topo.connect(dsc, 0, sink, 0)
assert topo.wait_inactive()
assert np.array_equal(sink.get_buffer(), bits)
assert not np.array_equal(mid.get_buffer(), bits)
lib = Path(native.get_lib()._name)
assert lib.is_file() and lib.parent == build.BUILD_DIR, lib
assert repo not in lib.parents and Path(sys.prefix) not in lib.parents, lib
print("native LFSR built from the wheel into", lib.parent)

assert not [m for m in sys.modules if m.split(".")[0] == "jax"], "jax imported"
print("no jax imported")
EOF

echo "== smoke: console script =="
N_BLOCKS=$("$WORK/venv/bin/pothoscomms-tpu-torch" list | wc -l)
echo "pothoscomms-tpu-torch lists $N_BLOCKS registered block paths"
test "$N_BLOCKS" -eq 116
set +e
"$WORK/venv/bin/pothoscomms-tpu-torch" bench --device cpu fft_64ch_1024 \
  > "$WORK/bench.out" 2> "$WORK/bench.err"
RC=$?
set -e
echo "pothoscomms-tpu-torch bench exits $RC: $(cat "$WORK/bench.err")"
test "$RC" -eq 2
grep -q "source checkout" "$WORK/bench.err"
test ! -s "$WORK/bench.out"

echo "WHEEL SMOKE (torch) PASSED"
