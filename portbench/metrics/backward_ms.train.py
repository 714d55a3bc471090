"""Device ms a train step launched inside the program's `backward` span
(`torch.autograd.grad`, from autograd's thread too), from
`portbench/spans.py`."""
from portbench.spans import self_device_ms


def read(ctx):
    return self_device_ms(ctx, 'train', ['backward'])
