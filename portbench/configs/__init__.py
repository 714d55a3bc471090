"""Configurations: ``configs/<name>.json`` holds one configuration as it
is run (its source, the keys changed from it, what it assumes, the
model, head and train entries, its precision)."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict

HERE = Path(__file__).resolve().parent


def load(name: str) -> Dict[str, Any]:
    path = HERE / f'{name}.json'
    if not path.is_file():
        raise FileNotFoundError(f'no configuration {name!r} ({path})')
    return json.loads(path.read_text())
