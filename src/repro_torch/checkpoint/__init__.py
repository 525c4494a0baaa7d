"""Training checkpoints, serving bundles and weight conversion (port of
:mod:`repro.checkpoint`)."""

from .convert import params_from_jax  # noqa: F401
from .store import (  # noqa: F401
    DEFAULT_MODEL_ID,
    SERVING_SCHEMA,
    UnknownServingSchemaError,
    config_to_meta,
    latest_step,
    load_serving_bundle,
    load_serving_manifest,
    restore_checkpoint,
    save_checkpoint,
    save_serving_bundle,
)
