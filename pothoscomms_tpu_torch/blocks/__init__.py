"""Block catalog of the port — importing this package registers every
ported block factory in the port's own registry: the test fixtures,
/comms/fft, /comms/fir_filter, /comms/iir_filter, /comms/freq_demod,
/comms/dc_removal, /comms/envelope_detector, /comms/fir_designer,
/comms/iir_designer; the digital blocks /comms/bits_to_symbols,
/comms/symbols_to_bits, /comms/symbols_to_bytes, /comms/bytes_to_symbols,
/comms/symbol_mapper, /comms/symbol_slicer, /comms/differential_encoder,
/comms/differential_decoder, /comms/scrambler, /comms/descrambler,
/comms/bitwise_unary, /comms/bitwise_binary, /comms/const_bitwise_binary,
/comms/bitshift and /comms/byte_order; and the framing blocks
/comms/preamble_framer, /comms/frame_insert, /comms/preamble_correlator
and /comms/frame_sync; the 35 math blocks (/comms/arithmetic ...
/comms/modf); the sources /comms/waveform_source and /comms/noise_source;
and /comms/window_designer (most also under their /blocks/... aliases).
The rest of the JAX package's catalog (the utility and MAC blocks) is
still to port (ROADMAP.md Queue 1).
"""

import pothoscomms_tpu_torch.core.fixtures  # noqa: F401  test fixture blocks

from pothoscomms_tpu_torch.blocks import demod  # noqa: F401
from pothoscomms_tpu_torch.blocks import digital  # noqa: F401
from pothoscomms_tpu_torch.blocks import fft  # noqa: F401
from pothoscomms_tpu_torch.blocks import filter  # noqa: F401
from pothoscomms_tpu_torch.blocks import framing  # noqa: F401
from pothoscomms_tpu_torch.blocks import math  # noqa: F401
from pothoscomms_tpu_torch.blocks import sources  # noqa: F401
from pothoscomms_tpu_torch.blocks import window  # noqa: F401
