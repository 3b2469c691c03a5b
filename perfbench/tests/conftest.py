"""A checkout of the benchmark in a temporary directory, to which a test adds
a configuration as a later change would: new files, and new entries in
``BENCHMARK.json``, with no file of the benchmark edited."""
import hashlib
import json
import os
import shutil

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def digests(top: str) -> dict:
    """{path under ``top``: sha1 of its bytes} of every file of the
    benchmark's own (its tests and caches left out)."""
    out = {}
    for dirpath, dirnames, files in os.walk(top):
        dirnames[:] = [d for d in dirnames
                       if d not in ("tests", "__pycache__")]
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, top)] = hashlib.sha1(
                    fh.read()).hexdigest()
    return out


class Checkout:
    """``BENCHMARK.json`` and ``perfbench/`` copied under ``root``."""

    def __init__(self, root: str):
        self.root = root
        shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
        shutil.copytree(os.path.join(ROOT, "perfbench"),
                        os.path.join(root, "perfbench"),
                        ignore=shutil.ignore_patterns("tests", "__pycache__"))
        self.before = digests(os.path.join(root, "perfbench"))

    def add(self, path: str, text: str):
        """A new file ``perfbench/<path>``."""
        p = os.path.join(self.root, "perfbench", path)
        assert not os.path.exists(p), f"{path} is not new"
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "w") as fh:
            fh.write(text)

    def add_json(self, path: str, obj):
        self.add(path, json.dumps(obj, indent=1))

    def add_entries(self, **groups):
        """New entries appended to BENCHMARK.json's lists (``configs``,
        ``workloads``, ``end_to_end``, ``per_layer``)."""
        p = os.path.join(self.root, "BENCHMARK.json")
        with open(p) as fh:
            bench = json.load(fh)
        for key, items in groups.items():
            bench[key] = bench[key] + list(items)
        with open(p, "w") as fh:
            json.dump(bench, fh, indent=1)

    def edited(self) -> list:
        """Files of the copied benchmark that differ from the repo's."""
        now = digests(os.path.join(self.root, "perfbench"))
        return sorted(p for p, d in self.before.items() if now.get(p) != d)


@pytest.fixture
def checkout(tmp_path):
    return Checkout(str(tmp_path))
