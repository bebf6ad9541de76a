"""Share of the traced stretch in which no kernel or copy ran on the device
(the union of their intervals)."""


def read(r):
    if not r.kernels:
        return None
    return 100.0 * r.idle_share()
