"""Window designer block (reference: window/WindowDesigner.cpp); the port
of the JAX package's ``blocks/window.py``.

Event-only block: every setter recalculates and emits "tapsChanged" with
the window taps (computed on the host in float64 by ``design/windows.py``).
"""

from __future__ import annotations

from typing import List

from pothoscomms_tpu_torch.core.block import Block
from pothoscomms_tpu_torch.core.registry import register_block
from pothoscomms_tpu_torch.design import design_window


@register_block("/comms/window_designer")
class WindowDesigner(Block):
    DOC = {
        "category": "/Filter",
        "keywords": ["window", "hann", "hamming", "taps"],
        "params": {
            "window_type": {
                "label": "Window Type",
                "options": [{"label": w.title(), "value": w} for w in
                            ("rectangular", "hann", "hamming", "blackman",
                             "bartlett", "flattop", "kaiser",
                             "chebyshev")],
                "default": "hann",
            },
            "window_args": {"label": "Window Args", "default": [],
                            "preview": "valid"},
            "num_taps": {"label": "Num Taps", "default": 51,
                         "widget": "SpinBox(minimum=1)"},
        },
    }

    def __init__(self):
        super().__init__()
        self._window_type = "hann"
        self._window_args: List[float] = []
        self._num_taps = 51
        self.register_signal("tapsChanged")

    def set_window_type(self, wtype: str):
        self._window_type = wtype
        self.recalculate()

    def window_type(self) -> str:
        return self._window_type

    def set_window_args(self, args):
        self._window_args = list(args)
        self.recalculate()

    def window_args(self):
        return self._window_args

    def set_num_taps(self, num: int):
        self._num_taps = int(num)
        self.recalculate()

    def num_taps(self) -> int:
        return self._num_taps

    def activate(self):
        self.recalculate()

    def recalculate(self):
        if not self.is_active():
            return
        if self._num_taps == 0:
            raise ValueError("num taps must be positive")
        window = design_window(
            self._window_type, self._num_taps,
            self._window_args[0] if self._window_args else 0.0,
        )
        self.emit_signal("tapsChanged", window)
