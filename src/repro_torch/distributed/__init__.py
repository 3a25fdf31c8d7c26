"""Host-side distributed helpers of the port (straggler detection)."""
