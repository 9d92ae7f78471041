"""Functional cores of the port's blocks, in torch ops (the counterpart of
the JAX package's ``ops/``): the polyphase FIR, DC removal and envelope
follower (:mod:`.filter`), complex-integer arithmetic (:mod:`.cint`) and
the fixed-point helpers (:mod:`.fxpt`).
"""
