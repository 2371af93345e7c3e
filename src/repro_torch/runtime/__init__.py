"""``repro_torch.runtime`` — the execution API (port of ``repro.runtime``).

    from repro_torch.runtime import Runtime

    rt = Runtime(backend="reference", device="cpu", bm=16, bk=32, bn=16)
    y = rt.matmul(a, b)
    with rt.use():
        logits = model.forward(params, cfg, batch)
"""
from repro_torch.runtime.backends import (
    BackendCapabilityError,
    KernelBackend,
    KernelRequest,
    available_backends,
    get_backend,
    register_backend,
)
from repro_torch.runtime.plan import (
    PlanCache,
    SparsityPlan,
    dense_operand_plan,
    plan_from_emitted_mask,
    plan_operand,
)
from repro_torch.runtime.runtime import (
    GEOMETRIES,
    Runtime,
    cache_batch_axes,
    current,
    default_runtime,
    resolve,
    tree_map,
    use,
)

__all__ = [
    "GEOMETRIES",
    "Runtime",
    "use",
    "current",
    "resolve",
    "default_runtime",
    "cache_batch_axes",
    "tree_map",
    "KernelBackend",
    "KernelRequest",
    "BackendCapabilityError",
    "register_backend",
    "get_backend",
    "available_backends",
    "SparsityPlan",
    "PlanCache",
    "plan_operand",
    "plan_from_emitted_mask",
    "dense_operand_plan",
]
