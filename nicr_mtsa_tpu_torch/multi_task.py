"""Task registry (counterpart of nicr_mtsa_tpu/multi_task.py).

The canonical task order determines the order of decoder outputs in
multi-task models and the iteration order of task helpers."""

KNOWN_TASKS = (
    'semantic',
    'instance',
    'orientation',      # part of the instance decoder (3rd head)
    'normal',
    'scene',
    'panoptic',         # derived: semantic + instance + merge
    'dense_visual_embedding',
)


class EnabledTasksInTheOrderTheyAppearInPredictions(tuple):
    """Ordered, validated tuple of enabled task names."""

    def __new__(cls, tasks):
        tasks = tuple(tasks)
        for t in tasks:
            if t not in KNOWN_TASKS:
                raise ValueError(f"Unknown task: '{t}'")
        ordered = tuple(t for t in KNOWN_TASKS if t in tasks)
        return super().__new__(cls, ordered)
