from .compiler import Plan, Step, compile_plan, sweep_order

__all__ = ["Plan", "Step", "compile_plan", "sweep_order"]
