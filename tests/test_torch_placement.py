"""The port's entry points run on the card unless the caller names a device.

Each entry point is called with no device. On a machine with a card its
tensors land there; without one (torch built for the CPU, or no card),
the call raises torch's own error on its first allocation instead of
carrying on on the CPU. Whether there is a card is decided inside each
test, so every worker collects the same tests.
"""

import numpy as np
import pytest
import torch

import pothoscomms_tpu_torch as pkg
from pothoscomms_tpu_torch.core import placement
from pothoscomms_tpu_torch.kernels import fir_fft_fused as ff
from pothoscomms_tpu_torch.ops import framing
from pothoscomms_tpu_torch.parallel import chain, compiler, link

torch.set_num_threads(1)


def _fm_blocks():
    demod = pkg.BlockRegistry.make("/comms/freq_demod", "complex_float32")
    dc = pkg.BlockRegistry.make("/comms/dc_removal", "float32")
    env = pkg.BlockRegistry.make("/comms/envelope_detector", "float32")
    return [demod, dc, env]


def _config3_blocks():
    fir = pkg.BlockRegistry.make("/comms/fir_filter", "complex_float32",
                                 "COMPLEX")
    fir.set_taps(np.ones(60) / 60)
    fir.set_decimation(2)
    fir.set_interpolation(3)
    return [fir, pkg.BlockRegistry.make("/comms/iir_filter",
                                        "complex_float32")]


def _zeros(*shape):
    return np.zeros(shape, np.float32)


def _lone(path, *args):
    return pkg.BlockRegistry.make(path, *args)


def _active(blk):
    blk._active = True
    return blk


def _frame_sync_search():
    fs = _lone("/comms/frame_sync", "complex_float32")
    fs._search_arrays(np.zeros(1024, np.complex64), 8)
    return fs._search


# each builds something that holds tensors, with no device named
ENTRY_POINTS = {
    "fir_fft_chain": lambda: chain.fir_fft_chain(np.ones(8) / 8, 64, 2, 256),
    "fir_fft_chain_conv": lambda: chain.fir_fft_chain(np.ones(200) / 200,
                                                      64, 2, 256),
    "FirFftChain": lambda: chain.FirFftChain(np.ones(8) / 8, 64, 256),
    "make_fused_chain": lambda: ff.make_fused_chain(np.ones(8) / 8, 1024),
    "compile_chain": lambda: compiler.compile_chain(_fm_blocks(), 2),
    "device_core": lambda: _fm_blocks()[1].device_core(2),
    "make_split_step": lambda: chain.make_split_step(np.ones(8) / 8, 256,
                                                     4, 16),
    "SplitFirFftChain": lambda: chain.SplitFirFftChain(np.ones(8) / 8, 256,
                                                       8, 16),
    "compile_chain_config3": lambda: compiler.compile_chain(
        _config3_blocks(), 2),
    "rational_device_core": lambda: _config3_blocks()[0].device_core(2),
    "iir_device_core": lambda: _config3_blocks()[1].device_core(2),
    "operators_from_numpy": lambda: chain.operators_from_numpy(
        (_zeros(3, 4), (_zeros(2), _zeros(5)))),
    "carry_from_numpy": lambda: chain.carry_from_numpy(_zeros(2, 7, 2)),
    "chain_carry_from_numpy": lambda: compiler.chain_carry_from_numpy(
        (_zeros(2, 1, 2), (_zeros(2, 2, 16),), (_zeros(2),))),
    "fused_consts_from_numpy": lambda: ff.fused_consts_from_numpy(
        (None, None, None, (_zeros(8, 128), _zeros(8, 128)),
         (_zeros(64, 1024), _zeros(64, 1024)))),
    # the digital and framing layers
    "scrambler_fuse_export": lambda: _lone("/comms/scrambler").fuse_export(
        1),
    "differential_encoder_fuse_export": lambda: _lone(
        "/comms/differential_encoder").fuse_export(2),
    "make_sync_search": lambda: framing.make_sync_search([1.0], 20, 4,
                                                         0.01),
    "make_hamming_profile": lambda: framing.make_hamming_profile([1, 0, 1]),
    "frame_sync_search": _frame_sync_search,
    "make_channel_search": lambda: link.make_channel_search(
        [1.0], 20, 4, 0.01, 100)[0](_zeros(2, 1024, 2)),
    "run_link": lambda: link.run_link(1, 16)["x"],
    # the sources and the math catalog
    "waveform_source_fuse_source_export": lambda: _active(_lone(
        "/comms/waveform_source", "complex_float32")).fuse_source_export(1),
    "noise_source_fuse_source_export": lambda: _active(_lone(
        "/comms/noise_source", "complex_float32", 3)).fuse_source_export(1),
}


def _device_types(obj) -> set:
    """The device types of every tensor in obj (tensors, modules, nested
    tuples and lists, and the tensors a closure holds)."""
    if isinstance(obj, torch.Tensor):
        return {obj.device.type}
    if isinstance(obj, torch.nn.Module):
        return {b.device.type for b in obj.buffers()}
    if isinstance(obj, (tuple, list)):
        return set().union(*(_device_types(o) for o in obj))
    if callable(obj) and getattr(obj, "__closure__", None):
        return set().union(*(_device_types(c.cell_contents)
                             for c in obj.__closure__
                             if isinstance(c.cell_contents, torch.Tensor)))
    return set()


def test_the_default_is_the_card():
    assert placement.DEFAULT_DEVICE == torch.device("cuda")
    assert placement.resolve(None) == torch.device("cuda")
    assert placement.resolve("cpu") == torch.device("cpu")
    assert pkg.Topology().device == torch.device("cuda")
    assert pkg.Topology(device="cpu").device == torch.device("cpu")
    blk = pkg.BlockRegistry.make("/comms/dc_removal", "float32")
    assert blk.device == torch.device("cuda")      # outside any topology
    pkg.Topology(device="cpu")._register(blk)
    assert blk.device == torch.device("cpu")


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_lands_on_the_card_or_raises(name):
    build = ENTRY_POINTS[name]
    if torch.cuda.is_available():
        assert _device_types(build()) == {"cuda"}
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            build()


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_follows_the_one_default(name, monkeypatch):
    """With the one default pointed at the CPU, the same calls build on
    the CPU: nothing else in the port chooses their device."""
    monkeypatch.setattr(placement, "DEFAULT_DEVICE", torch.device("cpu"))
    built = ENTRY_POINTS[name]()
    assert _device_types(built) == {"cpu"}


def test_topology_without_a_device_does_not_fall_back_to_the_cpu():
    """A float32 FFT block in Topology() streams on the card; without one
    the run raises rather than computing on the CPU."""
    from pothoscomms_tpu_torch.core.fixtures import CollectorSink, FeederSource

    feed = FeederSource("complex_float32")
    fft = pkg.BlockRegistry.make("/comms/fft", "complex_float32", 16, False)
    sink = CollectorSink("complex_float32")
    topo = pkg.Topology()
    topo.connect(feed, 0, fft, 0)
    topo.connect(fft, 0, sink, 0)
    feed.feed_buffer(np.ones(64, np.complex64))
    if torch.cuda.is_available():
        topo.commit()
        assert topo.wait_inactive()
        assert sink.get_buffer().shape == (64,)
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            topo.commit()
            topo.wait_inactive()


def _const_arithmetic_work():
    blk = _lone("/comms/const_arithmetic", "float32", "X+K", 1.0)
    blk.input(0).push_buffer(np.ones(8, np.float32))
    blk.work()


MATH_STREAMS = {  # a lone float32 math block's streaming core, no device
    "scale": lambda: _lone("/comms/scale", "complex_float32")._kernel(
        np.ones(4, np.complex64)),
    "rotate": lambda: _lone("/comms/rotate", "complex_float32")._kernel(
        np.ones(4, np.complex64)),
    "const_arithmetic": _const_arithmetic_work,
}


@pytest.mark.parametrize("name", list(MATH_STREAMS))
def test_lone_math_and_source_blocks_resolve_to_the_card(name):
    """A math or source block outside any topology names the card as its
    device, and its float32 work runs there (raising without a card)."""
    for path, args in (("/comms/scale", ("float32",)),
                       ("/comms/abs", ("complex_float32",)),
                       ("/comms/modf", ("float32",)),
                       ("/comms/arithmetic", ("complex_float32", "ADD")),
                       ("/comms/waveform_source", ("complex_float32",)),
                       ("/comms/noise_source", ("complex_float32",))):
        assert _lone(path, *args).device == torch.device("cuda")
    if torch.cuda.is_available():
        MATH_STREAMS[name]()
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            MATH_STREAMS[name]()
