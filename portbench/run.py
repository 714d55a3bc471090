"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

Runs only on a CUDA card (exits 2 without one, or with fewer cards than
the cell asks for), never on the CPU.  The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
ones), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``: each number compared with the reference beside its limit,
also printed as the last lines of standard error.  Exits 3 if JAX or the
JAX package was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'mmdet3d_gaussian_tpu')
# build and kernel caches at fixed paths inside the checkout
CACHES = {'TORCH_EXTENSIONS_DIR': 'build/torch_extensions',
          'TRITON_CACHE_DIR': 'build/triton_cache'}


def forbidden_modules():
    return sorted({name.split('.')[0] for name in sys.modules}
                  & set(FORBIDDEN))


def load_bench():
    return json.loads((ROOT / 'BENCHMARK.json').read_text())


def load_limits(name):
    return json.loads((ROOT / 'portbench' / 'limits'
                       / f'{name}.json').read_text())['limits']


def run_cell(name, seed, seconds, trace, device, t0=T0, cfg=None,
             traffic_over=None, wrap=None, limits=None, log=sys.stderr,
             world=None):
    """Run cell ``name`` once on ``device`` (a torch.device; a cell of
    several cards on as many ranks, ``world`` or else its ``chips``, rank
    r on card r): the whole run without the look for a card, which tests
    use on the CPU with a smaller ``cfg`` and traffic (``traffic_over``
    updates the mix) and a fault ``wrap``ped around the program's step.
    -> the result dict."""
    import torch
    from . import configs, loops, traffic
    from .loops.common import Run
    bench = load_bench()
    cell = next((w for w in bench['workloads'] if w['name'] == name), None)
    if cell is None:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json')
    cfg = cfg or configs.load(cell['config'])
    tf = dict(traffic.load(cell['traffic']), **(traffic_over or {}))
    tf32 = bool(cfg.get('tf32', False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    run = Run(name=name, cell=cell, bench=bench, cfg=cfg, traffic=tf,
              seed=int(seed), seconds=float(seconds), trace=bool(trace),
              device=device, t0=t0, wrap=wrap,
              limits=limits or load_limits(name), log=log,
              world=int(world or cell['chips']))
    return loops.get(tf['loop']).run(run)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for key, rel in CACHES.items():
        os.environ[key] = str(ROOT / rel)
    import torch
    bench = load_bench()
    cell = next((w for w in bench['workloads']
                 if w['name'] == args.workload), None)
    if cell is None:
        print(f'portbench: no workload {args.workload!r}', file=sys.stderr)
        return 2
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell['chips']):
        print(f'portbench: the cell needs {cell["chips"]} CUDA card(s); '
              f'found {torch.cuda.device_count()}', file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, args.trace,
                      torch.device('cuda', 0))
    found = forbidden_modules()
    if found:
        print(f'portbench: loaded {found}', file=sys.stderr)
        return 3
    for name, c in result['checks'].items():
        print(f'check {name}: {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
