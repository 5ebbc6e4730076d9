from repro_torch.kernels.vm_step.ops import vm_step
from repro_torch.kernels.vm_step.ref import vm_step_reference

__all__ = ["vm_step", "vm_step_reference"]
