"""Behavioural constants, each with its origin in the C++ ORB-SLAM2 sources
(file:line).

The port's own copy of the JAX package's `constants.py`:
tests/test_torch_system.py holds every public value equal. The three
environment-read constants read the same variables with the same defaults,
so one setting reaches both packages.
"""

import os

# --- Robust estimation / chi-square gates -------------------------------
# 95% quantiles of chi2 with 2 / 3 dof; mono (2D) and stereo (3D)
# reprojection edges (src/Optimizer.cc:124,163 and throughout).
CHI2_MONO = 5.991
CHI2_STEREO = 7.815
# Huber kernel deltas are sqrt of the above (src/Optimizer.cc:120,160).
HUBER_MONO = CHI2_MONO ** 0.5
HUBER_STEREO = CHI2_STEREO ** 0.5

# --- Descriptor matching (src/ORBmatcher.cc:37-39) ----------------------
TH_LOW = 50          # strict Hamming acceptance
TH_HIGH = 100        # loose Hamming acceptance
HISTO_LENGTH = 30    # rotation-consistency histogram bins
# stereo row-search acceptance = (TH_HIGH + TH_LOW)/2 (src/Frame.cc:499)
TH_STEREO = (TH_HIGH + TH_LOW) // 2

# --- Descriptor geometry (src/ORBextractor.cc:72-74) --------------------
PATCH_SIZE = 31
HALF_PATCH_SIZE = 15
EDGE_THRESHOLD = 19
DESC_BITS = 256      # 256-bit binary descriptor, 8 x uint32 words
DESC_WORDS = 8

# --- Covisibility / graphs ----------------------------------------------
COVIS_MIN_WEIGHT = 15        # covisibility edge threshold (src/KeyFrame.cc:315)
ESSENTIAL_MIN_WEIGHT = 100   # essential-graph covisibility edges (src/Optimizer.cc:806)
LOOP_CONSISTENCY_TH = 3      # consecutive consistent detections (src/LoopClosing.cc:43)

# --- Culling (src/LocalMapping.cc:170-205, 632-760) ---------------------
MIN_FOUND_RATIO = 0.25       # MapPoint culling: found/visible floor
MIN_OBS_FOR_POINT = 3        # observations needed to survive early culling
KF_REDUNDANT_RATIO = 0.9     # KeyFrame culled if 90% of points seen >=3x elsewhere
# Free cameras with fewer in-window observations than this are FIXED in
# the local-BA window (no reference counterpart: the reference's window
# carries all points of its free KFs, src/Optimizer.cc:488-546, while the
# fixed-shape point cap here can strip an old camera's constraints).
BA_MIN_OBS_PER_FREE_CAM = int(os.environ.get("BA_MIN_OBS_PER_FREE_CAM", "30"))
# Per-free-camera anchor quota in the capped BA window: every free camera
# keeps its oldest QUOTA observed points before the global newest-first
# fill (approximates the reference's uncapped per-KF point sets,
# src/Optimizer.cc:488-546).
BA_CAM_ANCHOR_QUOTA = int(os.environ.get("BA_CAM_ANCHOR_QUOTA", "96"))
KF_REDUNDANT_OBS = 3
# SearchInNeighbors second-degree expansion: each first-degree covisible
# neighbor contributes its 5 best neighbors (src/LocalMapping.cc:460-471);
# FUSE_EXT_SLOTS caps the dedup'd extension set (fixed shapes). Default 0:
# first-degree only.
SECOND_DEGREE_NEIGHBORS = 5
FUSE_EXT_SLOTS = int(os.environ.get("FUSE_EXT_SLOTS", "0"))
# chunk width of the mapper machine's fuse phases (targets per chunk)
FUSE_CHUNK = 5

# --- Tracking policy (src/Tracking.cc) ----------------------------------
TRACK_MOTION_MIN_MATCHES = 20      # Tracking.cc:899
TRACK_REF_KF_MIN_MATCHES = 15      # Tracking.cc:774
TRACK_LOCAL_MAP_MIN_INLIERS = 30   # Tracking.cc:971
TRACK_LOCAL_MAP_MIN_INLIERS_RECENT_RELOC = 50  # Tracking.cc:967
LOCAL_MAP_MAX_KFS = 80             # Tracking.cc:1285
RELOC_MIN_INLIERS = 50             # Tracking.cc:1490
MAX_CLOSE_STEREO_POINTS = 100      # new close points per stereo/RGBD KF (Tracking.cc:1119)
MIN_CLOSE_TRACKED = 100            # keyframe-need close-point gates (Tracking.cc:1016-1017)

# --- Place recognition (src/KeyFrameDatabase.cc:76-197) -----------------
BOW_COMMON_WORD_RATIO = 0.8     # >= 0.8 * maxCommonWords
BOW_ACC_SCORE_RATIO = 0.75      # accumulated-score cut
BOW_COVIS_GROUP = 10            # top-N covisible accumulation group
BOW_LEVELS_UP = 4               # FeatureVector grouping level (src/Frame.cc:399)

# --- Loop closing (src/LoopClosing.cc) ----------------------------------
LOOP_MIN_MATCHES_BOW = 20       # per-candidate BoW matches (LoopClosing.cc:277)
LOOP_MIN_INLIERS_SIM3 = 20      # OptimizeSim3 inliers (LoopClosing.cc:330)
LOOP_MIN_TOTAL_MATCHES = 40     # total after projection (LoopClosing.cc:395)
LOOP_MIN_KFS_GAP = 10           # skip if <10 KFs since last loop (LoopClosing.cc:109)

# --- Feature extraction defaults (Examples/*/ *.yaml) -------------------
DEFAULT_N_FEATURES = 1000
DEFAULT_SCALE_FACTOR = 1.2
DEFAULT_N_LEVELS = 8
DEFAULT_INI_TH_FAST = 20
DEFAULT_MIN_TH_FAST = 7

# --- Monocular initialization (src/Initializer.cc) ----------------------
INIT_RANSAC_ITERS = 200
INIT_SIGMA = 1.0
INIT_MODEL_SELECT_RH = 0.40     # RH = SH/(SH+SF) > 0.40 -> homography
INIT_MIN_TRIANGULATED = 50
INIT_MIN_PARALLAX_DEG = 1.0

# --- Pose optimization schedule (src/Optimizer.cc:239-451) --------------
POSE_OPT_ROUNDS = 4
POSE_OPT_ITS_PER_ROUND = 10
POSE_OPT_ROBUST_ROUNDS = 2       # Huber active for rounds 0,1 (kernel nulled at it==2)

# --- Local BA schedule (src/Optimizer.cc:453-778) -----------------------
LOCAL_BA_ITS_PHASE1 = 5
LOCAL_BA_ITS_PHASE2 = 10

# --- Essential graph (src/Optimizer.cc:781-1044) ------------------------
ESSENTIAL_GRAPH_ITERS = 20

# --- Global BA (src/LoopClosing.cc:650) ---------------------------------
GBA_ITERS = 10
INIT_GBA_ITERS = 20              # monocular init BA (Tracking.cc:686)
