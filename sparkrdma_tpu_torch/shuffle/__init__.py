"""The shuffle's host side and its bridge to the mesh: the mesh shuffle
service, the host-to-device on-ramp, positional merges of sorted runs."""
