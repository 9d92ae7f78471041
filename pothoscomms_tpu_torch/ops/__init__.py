"""Functional cores of the port's blocks, in torch ops (the counterpart of
the JAX package's ``ops/``): the polyphase FIR, DC removal and envelope
follower (:mod:`.filter`), complex-integer arithmetic (:mod:`.cint`),
the fixed-point helpers (:mod:`.fxpt`), the bit/symbol packing
(:mod:`.bits`), the digital blocks' fused cores (:mod:`.digital_device`),
the blocked GF(2) scrambler (:mod:`.gf2`) and the frame-sync search and
Hamming profile (:mod:`.framing`).
"""
