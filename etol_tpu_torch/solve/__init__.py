"""The batched AL-SQP solver and its shooting seeds."""
