"""The experiment programs of the system as functions of the port: the
multi-year coupled climate run (climate_run.py, stages A-E) and the twin
skill experiment (skill_experiment.py), on the twin data they share
(twin.py).

    python -m speedy_ml_tpu_torch.experiments climate --out DIR [fields]
    python -m speedy_ml_tpu_torch.experiments skill   --out DIR [fields]

Each stage is a function of its geometry, layout, sizes, device and
output paths; nothing is written but where the caller says.  The
programs run on CUDA; from Python, pass device="cpu" (or a set-up built
on the CPU) to run the kernels' plain versions.
"""

from speedy_ml_tpu_torch.experiments.climate_run import (ClimateConfig,
                                                         run_climate)
from speedy_ml_tpu_torch.experiments.skill_experiment import (SkillConfig,
                                                              run_skill)
from speedy_ml_tpu_torch.experiments.twin import (ExperimentAbort,
                                                  twin_setup)

__all__ = ["ClimateConfig", "ExperimentAbort", "SkillConfig", "run_climate",
           "run_skill", "twin_setup"]
