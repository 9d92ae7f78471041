"""Cost of in-row layout moves on one CUDA card: P2, the four permutations
A-D of a [4096, 1024] f32 array (the counterpart of
benches/probe_mosaic.py), beside P1's streaming roof at the same size.

    python3 benches_torch/probe_layout.py   # from the repo root

Prints one JSON line: per mode ``{M}_ms``, ``{M}_GBs`` (2*B*N*4 bytes per
call, one read and one write), ``{M}_plain_ms`` (the torch reshape /
permute form), ``{M}_device_ms`` and ``{M}_plain_device_ms`` (the same
calls' kernel time on the card by ``torch.profiler``, without the host's
enqueue gaps) and ``{M}_ok`` (kernel equal to the plain version); P1
(``stream_scale`` on two such planes, with a row tile of B / 512 rows so
that its grid fills the card, as the layout kernel's 8-row tiles do) and
``Tensor.copy_``; the card's name and power limit. Times are CUDA events
over 10 calls cycling through 8 inputs made on the card (128 MiB, above
the 50 MB L2), after two warm-up rounds; every call writes an output other
than the one the call before wrote (9 rotating outputs, 151 MiB), so that
neither side of a move stays in L2 from one call to the next. A device
time below ``bound_ms`` (the bytes over the published HBM rate) or with
profiler events missing is not kept: it reads null. Needs a CUDA card;
exits non-zero without one.
"""

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from probe_stream_ceiling import (  # noqa: E402
    bytes_bound_ms, card, device_ms, event_ms, random_pool)

from pothoscomms_tpu_torch.kernels.layout_move import (  # noqa: E402
    MODES, layout_move, layout_move_plain)
from pothoscomms_tpu_torch.kernels.stream_scale import (  # noqa: E402
    stream_scale)

B, N = 4096, 1024


def run(b: int = B, n: int = N) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("probe_layout: no CUDA card")
    dev = torch.device("cuda:0")
    xs = random_pool((b, n), 8, dev)
    pool = [(x,) for x in xs]
    nbytes = 2 * b * n * 4
    floor = bytes_bound_ms(nbytes)
    res = {"shape": [b, n], "bound_ms": floor}
    for mode in MODES:
        ms = event_ms(lambda x, m=mode: layout_move(x, m), pool)
        res[f"{mode}_ms"], res[f"{mode}_GBs"] = ms, nbytes / ms / 1e6
        res[f"{mode}_plain_ms"] = event_ms(
            lambda x, m=mode: layout_move_plain(x, m), pool)
        res[f"{mode}_device_ms"] = device_ms(
            lambda x, m=mode: layout_move(x, m), pool, per_call=1,
            floor_ms=floor)
        res[f"{mode}_plain_device_ms"] = device_ms(
            lambda x, m=mode: layout_move_plain(x, m), pool, floor_ms=floor)
        res[f"{mode}_ok"] = all(
            torch.equal(layout_move(x, mode), layout_move_plain(x, mode))
            for x in xs[:2])
    pairs = list(zip(xs[0::2], xs[1::2]))
    tb = max(1, b // 512)
    ms = event_ms(lambda xr, xi: stream_scale(xr, xi, tb), pairs)
    res["P1_tb"], res["P1_ms"], res["P1_GBs"] = tb, ms, 2 * nbytes / ms / 1e6
    copies = [(x, torch.empty_like(x)) for x in xs]
    ms = event_ms(lambda x, out: out.copy_(x), copies)
    res["copy_ms"], res["copy_GBs"] = ms, nbytes / ms / 1e6
    res["copy_device_ms"] = device_ms(lambda x, out: out.copy_(x), copies,
                                      per_call=1, floor_ms=floor)
    res["device"] = torch.cuda.get_device_name(0)
    res["card"] = card()
    return res


if __name__ == "__main__":
    print(json.dumps(run()))
    sys.exit(0)
