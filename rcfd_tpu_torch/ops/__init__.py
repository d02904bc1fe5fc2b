from .roi_pool import pool_rows_static, roi_pool_column
from .scatter import legacy_rewrite
