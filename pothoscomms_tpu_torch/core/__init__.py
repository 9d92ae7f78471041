"""The streaming runtime of the port: dtypes, Q-format helpers, labels,
packets, the block registry, the Block protocol, the Topology executor,
the fixture blocks and auto-fusion (the counterpart of the JAX package's
``core/``).
"""
