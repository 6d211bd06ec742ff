"""Random draws of the estimators, trajectory evaluation."""
