"""The virtual mesh, the ragged exchange and the fused device step."""
