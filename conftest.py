"""Repository-wide pytest settings: the marker for tests that need a GPU."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; skips where torch.cuda.is_available() is false",
    )
