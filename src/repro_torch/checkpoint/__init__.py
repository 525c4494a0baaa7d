"""Training checkpoints, serving bundles and weight conversion (port of
:mod:`repro.checkpoint`)."""

from .convert import params_from_jax  # noqa: F401
from .store import (  # noqa: F401
    DEFAULT_MODEL_ID,
    SERVING_SCHEMA,
    SERVING_SCHEMA_V1,
    SERVING_SCHEMA_V2,
    UnknownServingSchemaError,
    config_to_meta,
    latest_step,
    load_serving_manifest,
    load_serving_meta,
    restore_checkpoint,
    restore_serving_model,
    save_checkpoint,
    save_serving_bundle,
    save_serving_bundle_v1,
    save_serving_registry,
)
