"""Share of the SSM layers' decode steps that ran the fused step kernel,
in %: over the complete traced committed calls, the launches of
``ssm_decode_step`` (``repro_torch/kernels/csrc/ssm_step.cu``) among the
device operations of each call's decode loop (found as ``kbench/spans.py``
finds them: the run of equal blocks, one a step), over the steps those
calls ran times the model's SSM layers.  Layer: the model's SSM decode
step (``models/mamba2.py:mamba2_step``), which launches the kernel once
a layer on the ``attn_impl="pallas"`` route.  None for a model without
SSM layers, where no traced call's decode could be laid out, and for a
program without the kernel (no ``repro_torch.kernels.ssm_step``)."""
import importlib.util

from kbench import spans

KERNEL = "ssm_decode_step"


def read(run: dict):
    m = run["model"]
    if m["family"] != "ssm" or importlib.util.find_spec(
            "repro_torch.kernels.ssm_step") is None:
        return None
    calls = spans.traced_calls(run)
    if calls is None:
        return None
    steps = sum(len(c.blocks) for c in calls)
    ran = sum(KERNEL in name for c in calls for block in c.blocks
              for name, _, _ in block)
    return ran / (steps * m["layers"]) * 100.0 if steps else None
