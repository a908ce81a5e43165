"""End-to-end workloads: TeraSort."""
