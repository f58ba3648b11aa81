from .interface import (Drafter, SpeculationGate,  # noqa: F401
                        SpeculativeDecodingMode)
