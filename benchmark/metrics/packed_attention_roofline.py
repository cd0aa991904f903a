"""packed_attention_roofline.<kind> (``.eval``, ``.serve``): the least time
of the packed-attention calls the model made in the profiled stretch (each
call's shape recorded at ``models.layers``, ``portbench.trace.bound``: its
bytes over 3.35 TB/s or its FLOPs over the bf16 peak, whichever is larger),
as a share of the device time of the ``packed_attention`` kernels there.
Nothing to read where no call was made."""

from portbench.trace import bound


def read(run):
    kernel_ms = sum(e - s for name, s, e in run.profile["kernels"]
                    if "packed_attention" in name) / 1e3
    if not run.packed_calls or kernel_ms <= 0:
        return None
    return 100.0 * sum(bound(*c)[0] for c in run.packed_calls) / kernel_ms
