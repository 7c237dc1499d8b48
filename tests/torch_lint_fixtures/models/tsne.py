# the main path of the audit-contract fixture: what it calls in ops/ must
# declare a contract
from ops.fx_audit_contract import main_path_op


def optimize(x):
    return main_path_op(x)
