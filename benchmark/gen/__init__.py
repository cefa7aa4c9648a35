"""Frozen copies of the traffic generators: later changes to the port's
own generators cannot move the benchmark's inputs."""
