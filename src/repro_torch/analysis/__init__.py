from repro_torch.analysis.roofline import analyze_hlo, roofline_terms, RooflineReport

__all__ = ["analyze_hlo", "roofline_terms", "RooflineReport"]
