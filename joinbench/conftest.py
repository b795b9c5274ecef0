"""pytest settings of the benchmark's own tests (``python -m pytest joinbench``).

``card``: a test that needs an NVIDIA card; it decides inside its
fixture whether one is there and skips on a machine without one.
"""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")
