# Test-support utilities that ship with the port: the shared synthetic
# workloads its tests and examples build on, and the deterministic fault
# injector the core modules hook into (`faults` is imported by
# repro_torch.core and must stay free of repro_torch.core imports itself).
__all__ = ["synth", "faults"]
