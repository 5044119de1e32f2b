"""The shared training-step runtime (``step_runtime``): the fused step a
``Module`` trains through (:func:`module_stepper`, taken by
``Module.fit``), captured once in a CUDA graph on the card; the fused
update behind ``Module.update`` (:func:`fused_update_params`); and the
rules, guards and layouts they share with the JAX package's
``mxnet_tpu/perf``."""
from .step_runtime import (CompileGuard, FusedOptimizerApply, FusedStep,
                           ModuleStepper, PackedRNNLayout,
                           apply_fused_triples, functional_update,
                           fused_update_params, has_functional_update,
                           module_stepper, plan_param_layouts,
                           precision_compute_dtype, precision_loss_scale)

__all__ = ["CompileGuard", "FusedOptimizerApply", "FusedStep",
           "ModuleStepper", "PackedRNNLayout", "apply_fused_triples",
           "functional_update", "fused_update_params",
           "has_functional_update", "module_stepper", "plan_param_layouts",
           "precision_compute_dtype", "precision_loss_scale"]
