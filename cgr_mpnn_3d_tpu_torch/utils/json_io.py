"""JSON results persistence: a copy of ``cgr_mpnn_3d_tpu/utils/json_io.py``.

A results file is a single JSON object updated in place across runs; with
``add_training`` given, the payload nests under the checkpoint's stem so one
file accumulates train + test metrics per model.
"""

from __future__ import annotations

import json
from pathlib import Path

__all__ = ["json_dumper", "load_results"]


def load_results(fpath: str | Path) -> dict:
    """Current contents of a results file ({} when absent or corrupt)."""
    try:
        return json.loads(Path(fpath).read_text())
    except (FileNotFoundError, json.JSONDecodeError):
        return {}


def json_dumper(fpath: str, dictionary: dict, add_training: str | None = None
                ) -> None:
    """Merge ``dictionary`` into the results file at ``fpath``.

    ``add_training``: path of a saved model -- the payload merges under its
    basename-without-extension key."""
    data = load_results(fpath)
    if add_training:
        key = Path(add_training).name.rsplit(".", 1)[0]
        data.setdefault(key, {}).update(dictionary)
    else:
        data.update(dictionary)
    Path(fpath).write_text(json.dumps(data, indent=4, default=float))
