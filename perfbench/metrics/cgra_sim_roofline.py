"""cgra_sim_roofline (%): the least time of the window's executor calls
(``roofline.executor_bound``, summed over the batches) over the device time
of everything the ``cgra_sim`` call enqueues: the trace's zero fill
(``FillFunctor`` kernels, which on this path only ``cgra_sim``'s
``torch.zeros`` launches) and ``cgra_sim_kernel``."""


def read(record):
    dev, bound_s = record.get("device"), record.get("bound_s")
    if dev is None or not bound_s:
        return None
    kernel_s = dev.op_time("cgra_sim_kernel(")
    if kernel_s <= 0:
        return None
    return 100.0 * bound_s / (kernel_s + dev.op_time("FillFunctor<float>"))
