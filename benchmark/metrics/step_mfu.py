"""The whole step's share of the card's float32 peak outside the tensor
cores (67 TFLOP/s; the port runs float32 with TF32 off): the operations the
step needs (:func:`benchmark.costs.step_flops`), times the window's steps,
over the window's time."""

from benchmark import costs


def read(run: dict) -> float:
    t = run["cell"]["traffic"]
    flops = costs.step_flops(run["cell"]["config"], t["domain"], t["batch"],
                             t["nx"], t["ny"])
    w = run["window"]
    return 100.0 * flops * w["steps"] / w["seconds"] / costs.FP32_FLOP_PER_S
