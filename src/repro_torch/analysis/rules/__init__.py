"""The rule battery — importing this package registers every rule.

Adding a rule: drop a module here with a ``@register``-decorated
:class:`repro_torch.analysis.core.Rule` subclass and import it below (~30
lines total; see ``docs/analysis.md`` for the walkthrough).
"""
from repro_torch.analysis.rules import determinism  # noqa: F401
from repro_torch.analysis.rules import dtype        # noqa: F401
from repro_torch.analysis.rules import hygiene      # noqa: F401
from repro_torch.analysis.rules import identity     # noqa: F401
from repro_torch.analysis.rules import obs_guard    # noqa: F401
