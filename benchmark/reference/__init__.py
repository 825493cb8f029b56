"""The plain PyTorch reference that decides ``correct``. It imports
nothing of ``kbe_torch`` (``benchmark/tests/test_bench_guard.py``)."""
