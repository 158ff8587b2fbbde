from .plan import FactorPlan, plan_factorization

__all__ = ["FactorPlan", "plan_factorization"]
