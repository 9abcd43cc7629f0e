"""KERMIT core in PyTorch: the loop's components (port of ``repro.core``).

On-line:  monitor, change_detector, plugin, explorer, lstm.
Off-line: analyser, dbscan, characterize, forest, synthesizer.
Knowledge: knowledge (WorkloadDB).  Substrate: windows, simulator.

Programs drive them through the ``repro_torch.kermit`` facade.  The
``AutonomicManager`` exported here is the deprecated pre-facade shim.
"""
from repro_torch.core.windows import (FEATURES, NUM_FEATURES, WindowSeries,
                                      make_windows)
from repro_torch.core.change_detector import ChangeDetector, welch_t
from repro_torch.core.dbscan import agglomerative_single_link, dbscan, kmeans
from repro_torch.core.characterize import characterize, l2_drift
from repro_torch.core.forest import RandomForest, ForestConfig
from repro_torch.core.lstm import WorkloadPredictor, PredictorConfig
from repro_torch.core.synthesizer import synthesize, sample_pure
from repro_torch.core.explorer import Explorer, DEFAULT_SPACE
from repro_torch.core.knowledge import WorkloadDB, WorkloadRecord, UNKNOWN
from repro_torch.core.monitor import KermitMonitor, WorkloadContext
from repro_torch.core.analyser import KermitAnalyser, AnalysisReport
from repro_torch.core.plugin import KermitPlugin
from repro_torch.core.autonomic import AutonomicManager
