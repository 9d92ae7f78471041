"""MAC/LLC packet layer (reference: mac/ module, SURVEY.md §2.5); the port
of the JAX package's ``blocks/mac.py``. Host blocks: numpy byte framing,
CRC8 on the port's C++ host kernel (:mod:`pothoscomms_tpu_torch.native`).

/comms/simple_mac — 7-byte header CRC8 datagram framing.
/comms/simple_llc — Go-Back-N ARQ with resend/expire timers and SYN
resynchronization.

The reference LLC runs a 1 ms monitor thread that injects a resend
sentinel into its own macIn port (mac/SimpleLlc.cpp:140-162). Here the
timer is the executor's ``poll_timers`` hook: when the topology goes
idle, the scheduler polls timer-driven blocks, which re-arms work() —
same protocol behavior, no thread.
"""

from __future__ import annotations

import collections
import random
import time
from typing import Deque, Optional

import numpy as np

from pothoscomms_tpu_torch import native
from pothoscomms_tpu_torch.core.block import Block
from pothoscomms_tpu_torch.core.packet import Packet
from pothoscomms_tpu_torch.core.registry import register_block


def crc8(data) -> int:
    """CRC-8, x^8 + x^2 + x + 1 (reference: mac/MacHelper.hpp:18-32), on
    the C++ host kernel (no Python fallback: a failed build raises)."""
    return native.crc8(data)


@register_block("/comms/simple_mac", "/blocks/simple_mac")
class SimpleMac(Block):
    """4-port MAC: macIn->phyOut adds the CRC8 header; phyIn->macOut
    validates and strips it (reference: mac/SimpleMac.cpp)."""

    DOC = {
        "category": "/Packet",
        "keywords": ["mac", "crc", "packet", "header"],
        "params": {
            "mac_id": {"label": "MAC ID", "default": 0,
                       "desc": "16-bit address used as sender on TX and "
                               "accepted recipient on RX."},
        },
    }

    def __init__(self):
        super().__init__()
        self.setup_input("phyIn")
        self.setup_input("macIn")
        self.setup_output("phyOut")
        self.setup_output("macOut")
        self._id = 0
        self._error_count = 0
        self.register_probe("getErrorCount")

    def set_mac_id(self, mac_id: int):
        self._id = int(mac_id) & 0xFFFF

    def get_mac_id(self) -> int:
        return self._id

    def getErrorCount(self) -> int:
        return self._error_count

    get_error_count = getErrorCount

    def _unpack(self, pkt: Packet):
        """Validate an incoming PHY packet; returns (payload, sender,
        recipient) or None (reference :94-122)."""
        data = np.asarray(pkt.payload, np.uint8)
        if data.size < 7:
            return None
        sender = (int(data[1]) << 8) | int(data[2])
        recipient = (int(data[3]) << 8) | int(data[4])
        length = (int(data[5]) << 8) | int(data[6])
        if length > data.size:
            return None
        if recipient != self._id:
            return None
        if crc8(data[1:length]) != int(data[0]):
            return None
        return data[7:length], sender, recipient

    def work(self):
        phy_in, mac_in = self.input("phyIn"), self.input("macIn")
        phy_out, mac_out = self.output("phyOut"), self.output("macOut")

        if phy_in.has_message():
            msg = phy_in.pop_message()
            if isinstance(msg, Packet):
                result = self._unpack(msg)
                if result is not None:
                    payload, sender, recipient = result
                    meta = dict(msg.metadata)
                    # NB: the reference swaps sender/recipient at the
                    # unpack call site (SimpleMac.cpp:132-137) so
                    # metadata["recipient"] is the peer to reply to
                    meta["recipient"] = sender
                    meta["sender"] = recipient
                    mac_out.post_message(
                        Packet(payload, labels=list(msg.labels), metadata=meta)
                    )
                else:
                    self._error_count += 1

        if mac_in.has_message():
            msg = mac_in.pop_message()
            if not isinstance(msg, Packet):
                return
            if "recipient" not in msg.metadata:
                self._error_count += 1
                return
            recipient = int(msg.metadata["recipient"]) & 0xFFFF
            data = np.asarray(msg.payload, np.uint8)
            length = data.size + 7
            out = np.empty(length, np.uint8)
            out[1] = self._id >> 8
            out[2] = self._id & 0xFF
            out[3] = recipient >> 8
            out[4] = recipient & 0xFF
            out[5] = length >> 8
            out[6] = length & 0xFF
            out[7:] = data
            out[0] = crc8(out[1:length])
            phy_out.post_message(
                Packet(out, labels=list(msg.labels),
                       metadata=dict(msg.metadata))
            )


_PSH = 0x1
_REQ = 0x4
_SYN = 0x8
_RESEND_SENTINEL = ("__llc_resend__",)


@register_block("/comms/simple_llc", "/blocks/simple_llc")
class SimpleLlc(Block):
    """Go-Back-N ARQ LLC over SimpleMac (reference: mac/SimpleLlc.cpp).

    4-byte header: PORT NONCE16 CTRL with PSH/REQ/SYN control bits.
    """

    DOC = {
        "category": "/Packet",
        "keywords": ["llc", "arq", "go-back-n", "reliable"],
        "params": {
            "port": {"label": "Port", "default": 0},
            "window_size": {"label": "Window Size", "default": 0,
                            "widget": "SpinBox(minimum=1)"},
            "expire_timeout": {"label": "Expire Timeout", "units": "s",
                               "default": 0.0},
            "resend_timeout": {"label": "Resend Timeout", "units": "s",
                               "default": 0.0},
        },
    }

    def __init__(self, seed: Optional[int] = None):
        super().__init__()
        self.setup_input("macIn")
        self.setup_input("dataIn")
        self.setup_output("macOut")
        self.setup_output("dataOut")
        self._rng = random.Random(seed)
        self._resend_count = 0
        self._expired_count = 0
        self._port = 0
        self._recipient = 0
        self._metadata = {"recipient": 0}
        self._window_size = 4
        self._seq_base = 0
        self._seq_out = 0
        self._req_seq = 0
        # deque of [packet, expire_time, last_sent_time]
        self._sent: Deque[list] = collections.deque()
        # stale-REQ escalation state (see the REQ handler)
        self._stale_req = None
        self._stale_count = 0
        self._last_syn = None
        self.set_resend_timeout(0.01)
        self.set_expire_timeout(0.1)
        self.register_probe("getResendCount")
        self.register_probe("getExpiredCount")

    # -- configuration ---------------------------------------------------- #
    def set_port(self, port: int):
        self._port = int(port) & 0xFF

    def set_recipient(self, recipient: int):
        self._recipient = int(recipient) & 0xFFFF
        self._metadata = {"recipient": self._recipient}

    def set_resend_timeout(self, timeout: float):
        self._resend_timeout = float(timeout)

    def set_expire_timeout(self, timeout: float):
        self._expire_timeout = float(timeout)

    def set_window_size(self, window: int):
        self._window_size = int(window)

    def getResendCount(self) -> int:
        return self._resend_count

    def getExpiredCount(self) -> int:
        return self._expired_count

    get_resend_count = getResendCount
    get_expired_count = getExpiredCount

    def activate(self):
        # synchronize from a random starting sequence (reference :118-133)
        self._req_seq = self._rng.randrange(0, 1 << 16)
        self._seq_base = self._rng.randrange(0, 1 << 16)
        self._seq_out = self._seq_base

    # -- timer hook (replaces the reference's monitor thread) ------------- #
    def poll_timers(self) -> bool:
        """Expire/resend timer. Returns True while delivery is pending so
        the executor keeps the topology alive (the reference's 1 ms
        monitor thread would keep generating activity the same way)."""
        now = time.monotonic()
        while self._sent and self._sent[0][1] < now:
            self._sent.popleft()
            self._seq_base = (self._seq_base + 1) & 0xFFFF
            self._expired_count += 1
        if (self._sent and now - self._sent[0][2] > self._resend_timeout
                and _RESEND_SENTINEL not in self.input("macIn")._messages):
            # one sentinel at a time: the executor now polls timers on
            # EVERY round (not just at quiescence), and stacking
            # sentinels before work() runs would resend the window
            # back-to-back, churning the REQ/SYN plane
            self.input("macIn").push_message(_RESEND_SENTINEL)
        return bool(self._sent)

    def next_timer_deadline(self) -> Optional[float]:
        """Earliest monotonic time at which poll_timers() will act — lets
        the executor sleep instead of busy-spinning between timer events."""
        if not self._sent:
            return None
        return min(self._sent[0][1], self._sent[0][2] + self._resend_timeout)

    # -- header helpers ---------------------------------------------------- #
    def _fill_header(self, nonce: int, control: int) -> np.ndarray:
        return np.array([
            self._port, (nonce >> 8) & 0xFF, nonce & 0xFF, control
        ], np.uint8)

    def _post_control(self, nonce: int, control: int):
        self.output("macOut").post_message(
            Packet(self._fill_header(nonce, control),
                   metadata=dict(self._metadata))
        )

    def _resend_packets(self):
        now = time.monotonic()
        for item in self._sent:
            self.output("macOut").post_message(item[0])
            item[2] = now
            self._resend_count += 1

    # -- work --------------------------------------------------------------- #
    def work(self):
        mac_in, data_in = self.input("macIn"), self.input("dataIn")
        mac_out, data_out = self.output("macOut"), self.output("dataOut")

        while mac_in.has_message():
            msg = mac_in.pop_message()
            if msg == _RESEND_SENTINEL:
                self._resend_packets()
                continue
            if not isinstance(msg, Packet):
                continue
            data = np.asarray(msg.payload, np.uint8)
            if data.size < 4:
                continue
            port = int(data[0])
            nonce = (int(data[1]) << 8) | int(data[2])
            control = int(data[3])
            if port != self._port:
                continue
            if control & _SYN:
                # a duplicate of a recent SYN (nonce a little BEHIND
                # the live req_seq) must not rewind delivery; a genuine
                # peer restart lands far off and is adopted
                back = (self._req_seq - nonce) & 0xFFFF
                if not (0 < back <= max(2 * self._window_size, 8)):
                    self._req_seq = nonce
            if control & _PSH:
                if nonce == self._req_seq:
                    data_out.post_message(
                        Packet(data[4:], labels=list(msg.labels),
                               metadata=dict(msg.metadata))
                    )
                    self._req_seq = (self._req_seq + 1) & 0xFFFF
                self._post_control(self._req_seq, _REQ)
            if control & _REQ:
                # 16-bit serial-number arithmetic (RFC1982 style). The
                # reference's unwrapped compare (SimpleLlc.cpp:255)
                # resyncs spuriously on a stale REQ or at the 2^16
                # wrap, and a resync rewinds the receiver past frames
                # it already delivered (duplicate delivery) — with
                # timers now firing every round that window is
                # routinely hit under loss. Signed serial distance:
                # stale acks (behind seq_base) are IGNORED, in-window
                # acks advance, and only a genuinely-ahead REQ (peer
                # restart) forces the SYN resync.
                sdist = ((nonce - self._seq_base + 0x8000) & 0xFFFF) \
                    - 0x8000
                outstanding = (self._seq_out - self._seq_base) & 0xFFFF
                stale_slack = max(2 * self._window_size, 8)
                if 0 < sdist <= outstanding:
                    self._stale_req = None
                    for _ in range(sdist):
                        if self._sent:
                            self._sent.popleft()
                    self._seq_base = (self._seq_base + sdist) & 0xFFFF
                elif -stale_slack <= sdist <= 0:
                    # recently-acked region: a REQ delayed behind
                    # in-flight acks — ignoring it avoids the rewind,
                    # but the SAME nonce repeating means the peer is
                    # genuinely stuck (e.g. a startup draw landed in
                    # the stale band): escalate to the SYN resync
                    if self._stale_req == nonce:
                        self._stale_count += 1
                        if self._stale_count > 64:
                            self._post_control(self._seq_base, _SYN)
                            self._stale_req = None
                    else:
                        self._stale_req = nonce
                        self._stale_count = 1
                else:
                    # far out of window: peer restarted or first
                    # contact (random starting seq) — resync
                    self._stale_req = None
                    self._post_control(self._seq_base, _SYN)

        if len(self._sent) >= self._window_size:
            return  # flow controlled

        while data_in.has_message():
            msg = data_in.pop_message()
            if not isinstance(msg, Packet):
                continue
            data = np.asarray(msg.payload, np.uint8)
            payload = np.concatenate([
                self._fill_header(self._seq_out, _PSH), data
            ])
            self._seq_out = (self._seq_out + 1) & 0xFFFF
            pkt = Packet(payload, labels=list(msg.labels),
                         metadata=dict(self._metadata))
            mac_out.post_message(pkt)
            now = time.monotonic()
            self._sent.append([pkt, now + self._expire_timeout, now])
            if len(self._sent) >= self._window_size:
                break
