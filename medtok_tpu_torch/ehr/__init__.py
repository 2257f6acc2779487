"""EHR downstream (counterpart of ``medtok_tpu/ehr/``): the data model,
pandas-free parsers of the MIMIC-III / MIMIC-IV / EHRShot CSVs, the task
builders, and the outcome model's featurizer, model and trainer. The frozen
MedTok export (``embeddings_all``) is the model's code-embedding table."""

from medtok_tpu_torch.ehr.data import Event, Patient, Visit  # noqa: F401
from medtok_tpu_torch.ehr.parsers import (  # noqa: F401
    EHRShotDataset,
    MIMIC3Dataset,
    MIMIC4Dataset,
)
from medtok_tpu_torch.ehr.tasks import CodeMapper, PatientEHRTasks, build_labels  # noqa: F401
