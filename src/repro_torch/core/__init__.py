"""Detection, rules, fills, counters and the simulated error process."""
