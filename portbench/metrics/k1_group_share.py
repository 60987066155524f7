"""``k1_group_share``: the share of K1's device time in the traced stretch
that its lane-group kernel (``permute_kernel_group``, one state a group of
warp lanes) took, in %: 100 where every K1 launch of the stretch ran in
groups, 0 where none did or the stretch ran no K1.  None without a trace."""

from portbench.roofline.k1_poseidon import KERNEL_NAMES

GROUP_KERNEL = "permute_kernel_group"


def read(run):
    t = run.trace
    if t is None:
        return None
    k1 = t.kernel_seconds(KERNEL_NAMES)
    return 100.0 * t.kernel_seconds((GROUP_KERNEL,)) / k1 if k1 > 0 else 0.0
