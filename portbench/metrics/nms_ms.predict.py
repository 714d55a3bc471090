"""Device ms a request of the rotated NMS: K5 (the rotated IoU) and K6
(pack and sweep), by kernel name."""
from portbench.metrics.common import device_ms

KERNELS = ('rotated_iou_kernel', 'nms_pack_kernel', 'nms_sweep_kernel')


def read(ctx):
    if ctx.kind != 'predict':
        return None
    ms = device_ms(ctx, KERNELS)
    return ms or None
