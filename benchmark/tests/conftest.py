"""Settings of the benchmark's own tests (``pytest benchmark/tests``).

Tests marked ``cuda`` drive a cell on the card; each decides inside the
test whether a card is there, and skips with the reason if not.  Run
them on the card with ``python3 -m pytest benchmark/tests -m cuda``.
"""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")
