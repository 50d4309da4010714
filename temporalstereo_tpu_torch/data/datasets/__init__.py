"""Stereo-video datasets of the port (numpy samples, registered in
``utils/registry.py:DATASET_REGISTRY``)."""
