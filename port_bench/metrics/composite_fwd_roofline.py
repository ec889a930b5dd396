"""composite_fwd's share of its roofline, %: the least time its work
allows (roofline.py, counted by the reference on the profiled renders'
pair lists) over the device time of the kernel below in the profiled
stretch."""

KERNEL = "composite_fwd_kernel"


def read(run):
    bound = run.counters.get("composite_fwd.bound_s")
    spent = run.kernel_s(KERNEL)
    if not bound or spent is None:
        return None
    return 100.0 * bound / spent
