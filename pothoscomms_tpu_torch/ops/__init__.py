"""Functional cores of the port's blocks, in torch ops (the counterpart of
the JAX package's ``ops/``). So far: the polyphase FIR that
``/comms/fir_filter`` streams through (:mod:`.filter`).
"""
