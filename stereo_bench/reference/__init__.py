"""The benchmark's plain reference of TemporalStereo: the network and the
temporal update in plain PyTorch, float32, no kernels, built from a
configuration file's options.  It imports nothing of the measured program
(``test_bench_imports.py`` holds it to that)."""
