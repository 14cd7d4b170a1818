"""Benchmark package: the scenario registry lives in `scenarios.py`.

The import path mirrors the reference layout (src/starway/benchmarks/) so
bench-driving code ports over unchanged, but everything of substance —
Scenario subclasses, the SCENARIOS table, control-plane tags — is defined
in one module and re-exported here.
"""

from __future__ import annotations

from .scenarios import SCENARIOS, Scenario, ScenarioDefinition, ScenarioResult


def list_scenarios() -> list[str]:
    """Names of all registered scenarios, in registry order."""
    return [*SCENARIOS]


def get_scenario(name: str) -> Scenario:
    """Registry lookup with the available names in the error message."""
    if name not in SCENARIOS:
        raise ValueError(
            f"Unknown benchmark scenario {name!r}; available: {', '.join(SCENARIOS)}")
    return SCENARIOS[name]


__all__ = ["SCENARIOS", "Scenario", "ScenarioDefinition", "ScenarioResult",
           "get_scenario", "list_scenarios"]
