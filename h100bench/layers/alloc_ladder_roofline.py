"""Allocator kernel: ``alloc_ladder``'s share of its roofline over the
profiled launches, in %: the benchmark's byte count of each launch
(``counts.alloc_ladder_bytes`` / ``start_keep_bytes``, from its shapes)
at the HBM peak, over the kernel's device time.  The kernel is bound by
bytes: its operations are a few per byte."""
from h100bench import peaks


def read(t):
    dev_s, n = t.kernel_seconds("alloc_ladder")
    if n == 0 or dev_s <= 0 or n != t.extras.get("alloc_launches"):
        return None
    return 100.0 * t.extras["alloc_bytes"] / peaks.HBM_BYTES_PER_S / dev_s
