"""Block catalog of the port — importing this package registers every
ported block factory in the port's own registry: the test fixtures,
/comms/fft, /comms/fir_filter, /comms/iir_filter, /comms/freq_demod,
/comms/dc_removal, /comms/envelope_detector, /comms/fir_designer and
/comms/iir_designer. The rest of the JAX package's catalog is still to
port (ROADMAP.md Queue 1).
"""

import pothoscomms_tpu_torch.core.fixtures  # noqa: F401  test fixture blocks

from pothoscomms_tpu_torch.blocks import demod  # noqa: F401
from pothoscomms_tpu_torch.blocks import fft  # noqa: F401
from pothoscomms_tpu_torch.blocks import filter  # noqa: F401
