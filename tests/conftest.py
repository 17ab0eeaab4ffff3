"""Shared pytest settings: registers the ``cuda`` marker."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card and nvcc; skips with its reason elsewhere "
        "(run on the card with: python -m pytest -m cuda tests/test_torch_cuda.py)")
