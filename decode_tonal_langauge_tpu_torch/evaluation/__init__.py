"""Evaluation stage: trained checkpoints -> test metrics, no retraining."""
