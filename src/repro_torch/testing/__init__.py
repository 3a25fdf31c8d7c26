"""Testing utilities: the fault-injection harness (``repro_torch.testing.faults``)."""
