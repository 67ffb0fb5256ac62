from autorag_research_tpu_torch.reporting.service import ReportingService

__all__ = ["ReportingService"]
