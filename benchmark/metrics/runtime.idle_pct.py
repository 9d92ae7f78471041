"""runtime.idle_pct (%): the share of the traced window in which the card
idled while the host was inside the block API's runtime: the idle time
charged to an outermost program span named ``pc.topology.*``,
``pc.segment.*`` or ``pc.block.*`` (``idle_by_root``), over the window's
length. With the benchmark spans' share and "host other" it makes up
``device_idle_pct``. None without a trace, a device event or a program
span."""

from benchmark.harness import idle_pct

ROOTS = ("pc.topology.", "pc.segment.", "pc.block.")


def read(m: dict):
    return idle_pct(m.get("trace"), ROOTS)
