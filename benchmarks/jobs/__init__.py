"""One module per job kind: the benchmark's generator, the call into the
port's entry, the input bytes and the bytes the job's exchanges move."""
