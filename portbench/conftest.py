"""The benchmark's tests: ``card`` marks a test that needs a CUDA device; it
decides inside the test whether one is present and skips without."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")
