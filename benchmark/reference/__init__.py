"""The plain reference that decides ``correct``: NumPy and PyTorch only,
nothing of the port and nothing the port made. It voxelizes the raw
sweep, runs the network from the benchmark's weights (sparse convs by
gather and matrix product over rulebooks it builds itself), decodes the
anchors it generates, and judges the port's detections against its own
candidates.
"""
