"""Web serving tier of the port (counterpart of the JAX package's
``serve/``): the app, its routes, reports and pages."""
from .app import BrainTumorApp, create_server  # noqa: F401
from .reports import (calculate_medical_metrics,  # noqa: F401
                      generate_clinical_report)
