"""Host-side helpers of the shuffle: positional merges of sorted runs."""
