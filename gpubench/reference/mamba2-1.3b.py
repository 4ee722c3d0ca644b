"""Plain reference of mamba2-1.3b (arXiv:2405.21060) as the repo runs it: a
stack of ``n_layers`` pre-norm Mamba2 layers over the token embedding, then
the final norm and an untied ``lm_head``.  The equations are
:mod:`gpubench.reference.plain`'s; the configuration file's ``assumed``
lists where they depart from the published model."""
from gpubench.reference.plain import (Precision, exact_fp32,  # noqa: F401
                                      last_logits, loss, train)

FAMILY = "ssm"
