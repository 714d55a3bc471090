#!/usr/bin/env python3
"""Run a command and print each line of its output (standard error
merged in) after the seconds since the command started, then a last line
with its exit code and wall time; exit with the command's code.  Shows
where a long run such as ``chip_smoke.py`` spends its time:

    python3 stamp_lines.py python3 -u chip_smoke.py > chiprun_out/run.log
"""
import subprocess
import sys
import time


def main(argv) -> int:
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    for line in proc.stdout:
        sys.stdout.write(f'{time.perf_counter() - t0:8.1f} {line}')
        sys.stdout.flush()
    rc = proc.wait()
    wall = time.perf_counter() - t0
    print(f'{wall:8.1f} exit {rc}, wall {wall:.1f} s')
    return rc


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
