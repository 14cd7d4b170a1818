"""Test-support utilities shipped with the package.

:mod:`starway_tpu_torch.testing.faults` -- the TCP fault-injection proxy fabric
used by tests/test_faults.py (and usable by embedders to chaos-test their
own deployments).
"""

from .faults import FaultProxy  # noqa: F401
