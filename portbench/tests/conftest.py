"""The benchmark's own tests: CPU tests at a tiny size, and tests marked
``card`` that run on a CUDA card at the cells' sizes and skip without one
(each decides inside the test)."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
