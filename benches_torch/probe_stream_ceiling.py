"""Streaming ceiling of one CUDA card: P1, a x2 kernel over two f32 planes
[32768, 1024] at row tiles tb in {128, 256, 512} (the counterpart of
benches/probe_pallas_ceiling.py).

    python3 benches_torch/probe_stream_ceiling.py   # from the repo root

Prints one JSON line: per tile ``tb{N}_ms`` and ``tb{N}_GBs`` (2*2*B*N*4
bytes per call, two planes in and out, as the JAX probe counts), the
plain version's and ``Tensor.copy_``'s numbers beside them, the card's
name and its power limit. Times are CUDA events over 10 calls that cycle
through 4 input pairs made on the card (1 GiB, far above the 50 MB L2),
after one warm-up round. Needs a CUDA card; exits non-zero without one.
"""

import json
import subprocess
import sys

import torch

from pothoscomms_tpu_torch.kernels.stream_scale import (stream_scale,
                                                        stream_scale_plain)

B, N = 32768, 1024
TILES = (128, 256, 512)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def event_ms(fn, pool, calls: int = 10) -> float:
    """Mean ms per call of ``fn(*args)`` over ``calls`` calls cycling
    through ``pool``, by CUDA events, after one warm-up round."""
    for args in pool:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(calls):
        fn(*pool[i % len(pool)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def random_pool(shape, count: int, dev, seed: int = 0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, device=dev, generator=g) for _ in range(count)]


def run(b: int = B, n: int = N, tiles=TILES) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("probe_stream_ceiling: no CUDA card")
    dev = torch.device("cuda:0")
    planes = random_pool((b, n), 8, dev)
    pool = list(zip(planes[0::2], planes[1::2]))
    nbytes = 2 * 2 * b * n * 4
    res = {"shape": [b, n]}
    for tb in tiles:
        ms = event_ms(lambda xr, xi, tb=tb: stream_scale(xr, xi, tb), pool)
        res[f"tb{tb}_ms"] = ms
        res[f"tb{tb}_GBs"] = nbytes / ms / 1e6
    ms = event_ms(stream_scale_plain, pool)
    res["plain_ms"], res["plain_GBs"] = ms, nbytes / ms / 1e6
    outs = (torch.empty_like(planes[0]), torch.empty_like(planes[1]))

    def copy(xr, xi):
        outs[0].copy_(xr)
        outs[1].copy_(xi)

    ms = event_ms(copy, pool)
    res["copy_ms"], res["copy_GBs"] = ms, nbytes / ms / 1e6
    res["device"] = torch.cuda.get_device_name(0)
    res["card"] = card()
    return res


if __name__ == "__main__":
    print(json.dumps(run()))
    sys.exit(0)
