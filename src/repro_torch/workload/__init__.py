from repro_torch.workload.executor import QueryExecutor

__all__ = ["QueryExecutor"]
