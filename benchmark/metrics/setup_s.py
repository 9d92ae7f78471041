"""setup_s (s): from the start of the run's process to the start of the
measured window: imports, the card, inputs and weights from the seed,
building the program (and its kernels in a checkout's first run) and the
warm-up."""


def read(m: dict):
    return m.get("setup_s")
