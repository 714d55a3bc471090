"""The command on the card: each cell for a short window, its result line
as the contract reads it.  Marked ``gpu``; skips without a card."""
import json
import subprocess
import sys

import pytest

from portbench.run import ROOT

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize('name', ['pp_kitti_train', 'centerpoint_nus_predict'])
@pytest.mark.parametrize('trace', [0, 1])
def test_cell_on_the_card(cuda, name, trace):
    out = subprocess.run(
        [sys.executable, '-m', 'portbench.run', '--workload', name,
         '--seed', str(2 ** 31 + 3), '--seconds', '2', '--trace',
         str(trace)], cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res['correct'], res['checks']
    assert list(res)[-1] == 'checks'
    assert res['device']['platform'] == 'gpu' and res['device']['count'] == 1
    if trace:
        assert 0 < res['device']['busy_s'] <= res['device']['window_s']
        for key, m in res['metrics'].items():
            if key.startswith(('kernels_roofline', 'mfu')):
                assert 0 < m['value'] <= 100, key
