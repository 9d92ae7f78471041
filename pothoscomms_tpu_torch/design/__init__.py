"""Filter/window design library (control-plane, pure numpy).

Replaces the reference's external Spuce dependency (CMakeLists.txt:51-66;
used by filter/FIRDesigner.cpp, filter/IIRDesigner.cpp,
window/WindowDesigner.cpp). Everything here is re-derived from standard DSP
formulas — tap math runs at reconfiguration time on the host, never in the
streaming hot path, so it stays numpy.
"""

from pothoscomms_tpu_torch.design.windows import design_window
from pothoscomms_tpu_torch.design.firdes import design_fir, design_complex_fir
from pothoscomms_tpu_torch.design.remez import (
    remez,
    remez_estimate_num_taps,
    remez_estimate_atten,
    remez_estimate_bw,
    remez_estimate_weight,
)
from pothoscomms_tpu_torch.design.iirdes import design_iir

__all__ = [
    "design_window",
    "design_fir",
    "design_complex_fir",
    "design_iir",
    "remez",
    "remez_estimate_num_taps",
    "remez_estimate_atten",
    "remez_estimate_bw",
    "remez_estimate_weight",
]
