"""Device ms a request launched inside the program's `decode` span and
outside its `nms` children (sigmoid, top-k, box decoding, the merge;
`nms_ms.predict` reads K5 and K6), from `portbench/spans.py`."""
from portbench.spans import self_device_ms


def read(ctx):
    return self_device_ms(ctx, 'predict', ['decode'])
