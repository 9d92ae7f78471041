"""pothoscomms_tpu_torch — the PyTorch + CUDA port of pothoscomms_tpu.

The port targets one NVIDIA H100 (sm_90a). It imports ``torch`` and never
``jax`` or ``pothoscomms_tpu``; the JAX package stays as the reference
the port is tested against (``tests/test_torch_*.py``).

So far it covers:

- the FIR -> FFT chain as functions (:mod:`.parallel`) in three forms
  (the one-pass kernel of :mod:`.kernels.fir_fft_fused`, which
  ``fir_fft_chain`` takes at 1024 bins and K <= 65 taps; the combined
  operator, which it takes at other shapes; the split-stream step), its complex products and FFTs on
  hand-written CUDA kernels (:mod:`.kernels`, sources in ``csrc/``);
- the block API: the streaming runtime (:mod:`.core`), the fixture
  blocks, the filter blocks (FIR with rational rates, IIR, DC removal,
  envelope, the FIR and IIR designers), the FFT and the FM discriminator,
  the digital blocks (bit/symbol/byte conversions, symbol mapper and
  slicer, differential coding, scrambler and descrambler, the bitwise
  family, byte order) and the framing blocks (preamble framer, frame
  insert, preamble correlator, frame sync), the 35 math blocks, the
  waveform and noise sources, the window designer, the utility blocks
  (signal probe, threshold, split/combine complex, wave trigger) and the
  MAC/LLC layer (:mod:`.blocks`: every path of the JAX package's
  registry),
  the design library (:mod:`.design`) and auto-fusion
  (:mod:`.core.fusion`: label-transparent through the digital and
  elementwise blocks, fan-in heads, multi-output tails, and
  source-headed segments that engage cold), on the device a
  :class:`Topology` is given; stats, checkpoints and the docs catalog
  (:mod:`.core.introspect`), and the CLI's list, doc and catalog
  (``python -m pothoscomms_tpu_torch``);
- :func:`.parallel.compiler.compile_chain` over any of those blocks'
  fused cores;
- the channel-batched framed digital link (:mod:`.parallel.link`), whose
  frame-sync search is one launch of the S1 kernel
  (:mod:`.kernels.sync_search`) over every channel, and its receive side
  as a step on window batches already on the card
  (:func:`.parallel.link.make_link_receiver`); its bit-serial LFSR and
  checksums run on the C++ host kernels of :mod:`.native`.
"""

from pothoscomms_tpu_torch.core.block import Block
from pothoscomms_tpu_torch.core.dtypes import DType
from pothoscomms_tpu_torch.core.labels import Label
from pothoscomms_tpu_torch.core.packet import Packet
from pothoscomms_tpu_torch.core.registry import BlockRegistry, register_block
from pothoscomms_tpu_torch.core.topology import Topology

__version__ = "0.1.0"

__all__ = ["Block", "BlockRegistry", "DType", "Label", "Packet", "Topology",
           "register_block"]

import pothoscomms_tpu_torch.blocks  # noqa: E402,F401  registers the blocks
