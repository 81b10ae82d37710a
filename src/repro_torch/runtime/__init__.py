"""Fault tolerance (port of ``repro/runtime``): straggler-tolerant integer
sums and the elastic re-plan after failures."""
from repro_torch.runtime.elastic import ElasticPlan, plan_after_failures
from repro_torch.runtime.straggler import straggler_tolerant_sum
