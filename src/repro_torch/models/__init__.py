"""The LM zoo of the port: configs, layers, the Mamba (SSD) block and the
model assembly."""
