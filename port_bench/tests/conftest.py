"""The benchmark's tests run from the repository's root:

    python -m pytest port_bench/tests -q -p no:cacheprovider

Without a card the ``cuda`` ones skip; on the card:
``python -m pytest port_bench/tests -q -m cuda``."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
