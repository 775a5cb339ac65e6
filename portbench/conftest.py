"""The encoder cell's smoke sizes (``modernbert-docs-8k``) for the
benchmark's CPU tests: ``tests/conftest.py`` sizes every configuration of
``BENCHMARK.json`` from its tables, and this session fixture enters the
encoder's rows into them before any test of the directory runs, so that
each test file runs alone as well as with the others."""
from pathlib import Path

import pytest

TABLES = Path(__file__).resolve().parent / "tests" / "conftest.py"
ROWS = {"SMOKE_MODEL": dict(n_layers=6, d_model=64, n_heads=4, head_dim=16, d_ff=96, vocab_size=512,
                            max_seq_len=64, local_window=8),
        "SMOKE_SERVER": dict(lanes=4, buckets=[16, 32]),
        "SMOKE_CAL": dict(documents=32, mean_exit_layer=4.0),
        "SMOKE_SAMPLE": 1000}


@pytest.fixture(autouse=True, scope="session")
def encoder_smoke_sizes(request):
    for plugin in request.config.pluginmanager.get_plugins():
        if Path(getattr(plugin, "__file__", None) or "/").resolve() == TABLES:
            for table, row in ROWS.items():
                getattr(plugin, table).setdefault("modernbert_large", row)
