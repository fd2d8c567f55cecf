from .analysis import (
    HW, CollectiveCounter, RooflineReport, StepCounter, analyze_step,
    model_flops,
)

__all__ = ["HW", "RooflineReport", "analyze_step", "model_flops",
           "StepCounter", "CollectiveCounter"]
