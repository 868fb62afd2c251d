"""The benchmark's CPU tests run the harness on a tiny rig
(``data/``: a 96x72 camera, 64x96 projector, the cells' traffic
shortened; BENCHMARK.json's cells on it) with the program's plain versions; tests marked ``gpu`` need
a card and skip without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture
def card():
    """The first CUDA card; skips the test on a machine without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return "cuda:0"


def tiny_spec_of(spec: dict) -> dict:
    """BENCHMARK.json with every configuration's file the tiny rig's."""
    return {**spec, "configs": [{**c, "file": "configs/tiny.json"} for c in spec["configs"]]}


@pytest.fixture(scope="session")
def tiny_spec():
    from benchmark import harness

    return tiny_spec_of(harness.load_spec())


@pytest.fixture(scope="session")
def cache_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench_cache"))
