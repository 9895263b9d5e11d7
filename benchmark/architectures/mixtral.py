"""Mixtral: the Mistral decoder with a top-k router over sparse experts.
The build, the state and the reference branch on n_experts, so this is
architectures/mistral.py under Mixtral's model_type."""

from architectures.mistral import *  # noqa: F401,F403
