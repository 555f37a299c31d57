from .classification import (ClassificationDataset, evaluate_classifier,
                             load_csv_dataset)

__all__ = ["ClassificationDataset", "evaluate_classifier",
           "load_csv_dataset"]
