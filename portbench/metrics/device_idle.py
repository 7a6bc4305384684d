"""``device_idle`` (layer: the device; moves ``mlups``): the share of the
traced window, from the first traced deck's start to the last one's end,
in which no device operation (kernel, copy or set) ran, in percent. Busy
time is the union of the operations' intervals (``reference.union_us``).
Nothing to read without a trace or with no device operation in it."""

from portbench.trace import busy_us


def read(run):
    if run.trace is None:
        return None
    busy = busy_us(run.trace)
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / (run.trace.hi - run.trace.lo))
