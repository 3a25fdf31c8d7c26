from repro_torch.spectral.monitor import SpectralMonitor

__all__ = ["SpectralMonitor"]
