"""Web serving tier of the port (counterpart of the JAX package's
``serve/``): the app, its routes, the training jobs, reports and pages."""
from .app import BrainTumorApp, create_server  # noqa: F401
from .jobs import (TrainingJobManager,  # noqa: F401
                   get_web_training_progress, start_web_training,
                   stop_web_training, training_manager)
from .reports import (calculate_medical_metrics,  # noqa: F401
                      generate_clinical_report)
