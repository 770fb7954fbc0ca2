"""pytest settings of the benchmark's own tests: the ``cuda`` marker, for
tests that need an NVIDIA GPU and skip where there is none."""


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped where there is none")
