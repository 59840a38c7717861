"""The CPU tests' fixtures: few threads, restored after each test."""

from __future__ import annotations

import pytest


@pytest.fixture
def cpu_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
